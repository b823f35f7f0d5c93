"""Walk-routed serving: requests pinned to graph nodes, routed by walker
fleets, decoded by slot-based continuous batching.

The JAX package's ``launch/serve.py`` on the port's models and walk stack.
Two layers:

1. :class:`ServeEngine` — every slot advances one token per engine step,
   either prefilling (consuming its prompt) or generating (feeding back its
   own greedy argmax).  The scheduling contract is the reference's:

   * **Backpressure** — ``max_queue`` bounds the admission queue; a
     ``submit`` against a full queue sheds the request (``"queue_full"``)
     and returns ``False``.
   * **Deadlines** — an expired queue head is shed (``"deadline"``, or
     ``"node_down"`` when its node is in ``down_nodes``) exactly once: a
     second shed of the same request is a ``RuntimeError``.
   * **Cache budget** — ``prompt + max_new_tokens > cache_len - 1`` is a
     ``ValueError`` at ``submit``, never queued.
   * **Cache recycling** — when the shared write position reaches
     ``cache_len - 1`` the in-flight requests go back to the queue front,
     the cache is re-initialised and they replay (greedy decode is
     deterministic).
   * **Idle no-op** — a step with every slot empty burns neither an engine
     step nor a cache row.

   Latency is counted in engine ticks (``latency_percentiles``).

2. :class:`ServeSimulator` — requests arrive at nodes of a ragged graph
   (skewed by a per-node load, degree-proportional by default, so demand
   sits on the hubs); a W-walker :class:`~repro_torch.walk_sgd.fleet.
   WalkFleet` takes one batched ``walk_transition_ragged`` step per tick,
   picks up pending requests at the nodes it visits and submits them to
   the :class:`ServeEngine`.  The routing law comes through the trainer's
   METHODS seam (:func:`build_route_engine`, the load standing in for the
   Lipschitz vector), so each law's entrapment trade-off shows as
   requests/s, p99 ticks and visit Herfindahl.  Under a
   :class:`~repro_torch.core.faults.FaultModel` the fleet step is
   liveness-masked, dead nodes serve nothing, and pending work moves off
   nodes down ``relocate_after`` ticks.  Arrival traces
   (:func:`save_arrival_trace` / :func:`load_arrival_trace`, the
   reference's npz) replay an identical offered load.

Randomness: the workload is host numpy, the reference's bit for bit
(``default_rng(seed + 1)`` for arrivals and prompts, ``default_rng(seed +
2)`` for relocation targets).  The walk draws, per tick, in place of the
reference's ``fold_in(PRNGKey(seed), t)``: the Markov ``(n,)`` uniforms
(when a fault rate is positive), the ``(W, 3 + r)`` walk block, then the
rescue ``(W,)`` uniforms (when the rescue is on), from a
``torch.Generator`` seeded with ``seed``, or injected per tick
(:meth:`ServeSimulator.inject`, the parity tests' and the card-vs-CPU
replay's way).

    python -m repro_torch.launch.serve --arch mamba2-370m --nodes 2000 \
        --walkers 32 --method mhlj --ticks 200 --drain 100
    python -m repro_torch.launch.serve --arch mamba2-370m --scale full --standalone

(``--device cpu`` runs either on the CPU.)
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, get_arch, reduced
from repro_torch.core.engine import draw_uniforms
from repro_torch.core.entrapment import occupancy_concentration
from repro_torch.core.faults import FaultModel
from repro_torch.core.graphs import barabasi_albert
from repro_torch.data.synthetic import RegressionData
from repro_torch.models.factory import build_model
from repro_torch.walk_sgd import trainer as trainer_mod
from repro_torch.walk_sgd.fleet import WalkFleet

__all__ = [
    "Request",
    "ServeEngine",
    "ServeSimulator",
    "build_route_engine",
    "latency_percentiles",
    "load_arrival_trace",
    "save_arrival_trace",
    "main",
]


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray  # (len,) int32
    max_new_tokens: int
    node: int = -1  # graph node the request is pinned to (-1 = direct submit)
    deadline: Optional[int] = None  # last tick at which admission is allowed
    submit_tick: Optional[int] = None
    admit_tick: Optional[int] = None
    done_tick: Optional[int] = None
    generated: Optional[List[int]] = None
    done: bool = False
    shed: bool = False
    shed_reason: Optional[str] = None


def latency_percentiles(requests) -> Dict[str, float]:
    """p50/p95/p99 of ``done_tick - submit_tick`` over finished requests,
    in engine ticks; defined zeros when nothing finished."""
    lats = [
        r.done_tick - r.submit_tick
        for r in requests
        if r.done_tick is not None and r.submit_tick is not None
    ]
    if not lats:
        return {"p50_ticks": 0.0, "p95_ticks": 0.0, "p99_ticks": 0.0}
    arr = np.asarray(lats, np.float64)
    return {f"p{p}_ticks": float(np.percentile(arr, p)) for p in (50, 95, 99)}


def save_arrival_trace(path: str, trace) -> str:
    """Write an arrival trace, ``(tick, node, prompt_len)`` int64 rows, as
    the reference's npz (arrays ``tick``, ``node``, ``prompt_len``).

    ``sim.arrival_log`` after a run is such a trace; feeding it back through
    ``arrival_trace=`` replays the identical offered load, so the legs of a
    fault sweep face the same requests at the same nodes on the same ticks.
    An empty trace is stored as ``(0, 3)``; any other shape but ``(k, 3)``
    is a ``ValueError``.
    """
    arr = np.asarray(trace, dtype=np.int64)
    if arr.size == 0:
        arr = arr.reshape(0, 3)
    if arr.ndim != 2 or arr.shape[1] != 3:
        raise ValueError(
            f"arrival trace must be (k, 3) rows of (tick, node, "
            f"prompt_len); got shape {arr.shape}"
        )
    np.savez(path, tick=arr[:, 0], node=arr[:, 1], prompt_len=arr[:, 2])
    return path


def load_arrival_trace(path: str) -> np.ndarray:
    """Load :func:`save_arrival_trace` (either package's file): ``(k, 3)``
    int64, stably sorted by tick."""
    with np.load(path, allow_pickle=False) as z:
        arr = np.stack([z["tick"], z["node"], z["prompt_len"]], axis=1)
    return arr[np.argsort(arr[:, 0], kind="stable")].astype(np.int64)


class ServeEngine:
    """Slot-based continuous batching (contract in the module docstring,
    layer 1).

    ``model`` serves a built model (it must be ``cfg``'s); otherwise one is
    built with random weights from ``seed`` on ``device``.
    """

    def __init__(
        self,
        cfg,
        batch_size: int,
        cache_len: int,
        dtype=torch.float32,
        seed: int = 0,
        max_queue: Optional[int] = None,
        *,
        device="cuda",
        model=None,
    ):
        self.cfg = cfg
        if model is None:
            gen = torch.Generator(device=torch.device(device)).manual_seed(seed)
            model = build_model(cfg, dtype, device=device, generator=gen)
        elif model.cfg.name != cfg.name:
            raise ValueError(f"model {model.cfg.name} does not serve {cfg.name}")
        self.model = model
        self.device = model.device
        self.batch_size = batch_size
        self.cache_len = cache_len
        self.max_queue = max_queue
        self.reset()

    def reset(self) -> "ServeEngine":
        """Fresh serving state on the same model."""
        self.cache = self.model.init_cache(self.batch_size, self.cache_len)
        self.slots: List[Optional[Request]] = [None] * self.batch_size
        self.slot_pos = np.zeros(self.batch_size, np.int64)  # tokens consumed
        self.queue: List[Request] = []
        self.completed: List[Request] = []
        self.shed_requests: List[Request] = []
        self.shed_counts: Dict[str, int] = {}
        self.engine_steps = 0
        self.busy_slot_steps = 0
        self.cache_pos = 0  # shared KV write index, reset at each recycle
        self.cache_recycles = 0
        self.queue_depth_sum = 0.0
        self.queue_depth_max = 0
        self.down_nodes: set = set()
        return self

    def _step(self, cache, tokens: np.ndarray, pos: int):
        """One decode step of every slot: greedy next tokens (B,) and the
        new cache."""
        toks = torch.as_tensor(tokens, dtype=torch.int64, device=self.device)
        logits, cache = self.model.decode_step(toks, cache, pos)
        return logits.argmax(dim=-1).to(torch.int32).reshape(-1).cpu().numpy(), cache

    # -- scheduling ---------------------------------------------------------
    def submit(self, req: Request, tick: int = 0) -> bool:
        """Admit ``req`` to the queue; ``False`` = shed on backpressure."""
        plen = len(req.prompt)
        need = plen + req.max_new_tokens
        if plen == 0:
            raise ValueError(f"request {req.rid}: empty prompt")
        if need > self.cache_len - 1:
            raise ValueError(
                f"request {req.rid}: prompt ({plen}) + max_new_tokens "
                f"({req.max_new_tokens}) = {need} exceeds the cache budget "
                f"(cache_len - 1 = {self.cache_len - 1}); it could never "
                "finish within one cache epoch — split the request or raise "
                "cache_len"
            )
        if self.max_queue is not None and len(self.queue) >= self.max_queue:
            self.shed(req, "queue_full")
            return False
        req.generated = []
        if req.submit_tick is None:
            req.submit_tick = tick
        self.queue.append(req)
        return True

    def shed(self, req: Request, reason: str) -> None:
        """Drop ``req`` loudly, exactly once (double shed = RuntimeError)."""
        if req.shed:
            raise RuntimeError(
                f"request {req.rid} shed twice: "
                f"{req.shed_reason!r} then {reason!r}"
            )
        req.shed = True
        req.shed_reason = reason
        self.shed_counts[reason] = self.shed_counts.get(reason, 0) + 1
        self.shed_requests.append(req)

    def _fill_slots(self, tick: int = 0) -> None:
        for i in range(self.batch_size):
            if self.slots[i] is not None:
                continue
            while self.queue:
                req = self.queue.pop(0)
                if req.deadline is not None and tick > req.deadline:
                    self.shed(
                        req,
                        "node_down" if req.node in self.down_nodes
                        else "deadline",
                    )
                    continue
                req.admit_tick = tick
                self.slots[i] = req
                self.slot_pos[i] = 0
                break

    def _recycle(self, tick: int) -> None:
        """Cache epoch rollover: preempt in-flight requests to the queue
        front (they replay deterministically), re-init the cache."""
        inflight = [r for r in self.slots if r is not None]
        for r in inflight:
            r.generated = []
        self.queue[:0] = inflight
        self.slots = [None] * self.batch_size
        self.slot_pos[:] = 0
        self.cache = self.model.init_cache(self.batch_size, self.cache_len)
        self.cache_pos = 0
        self.cache_recycles += 1

    def _gather_tokens(self) -> np.ndarray:
        toks = np.zeros((self.batch_size, 1), np.int32)
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            p = self.slot_pos[i]
            if p < len(req.prompt):
                toks[i, 0] = req.prompt[p]
            elif req.generated:
                toks[i, 0] = req.generated[-1]
            else:
                toks[i, 0] = req.prompt[-1]
        return toks

    def step(self, tick: Optional[int] = None) -> None:
        """One engine step: every occupied slot consumes/produces one token.

        ``tick`` is the external clock; it defaults to ``engine_steps``.
        An all-empty step is a no-op.
        """
        if tick is None:
            tick = self.engine_steps
        self._fill_slots(tick)
        if all(s is None for s in self.slots):
            return
        if self.cache_pos >= self.cache_len - 1:
            self._recycle(tick)
            self._fill_slots(tick)
        # one shared cache write position; slots that joined mid-epoch
        # waste cache rows but stay correct because attention masks beyond
        # pos — exhaustion recycles the epoch (see _recycle)
        next_tok, self.cache = self._step(self.cache, self._gather_tokens(),
                                          self.cache_pos)
        self.engine_steps += 1
        self.cache_pos += 1
        self.queue_depth_sum += len(self.queue)
        self.queue_depth_max = max(self.queue_depth_max, len(self.queue))
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            self.busy_slot_steps += 1
            self.slot_pos[i] += 1
            if self.slot_pos[i] >= len(req.prompt):
                req.generated.append(int(next_tok[i]))
                if len(req.generated) >= req.max_new_tokens:
                    req.done = True
                    req.done_tick = tick
                    self.completed.append(req)
                    self.slots[i] = None

    def stats(self) -> dict:
        toks = sum(len(r.generated) for r in self.completed)
        return {
            "completed": len(self.completed),
            "generated_tokens": toks,
            "engine_steps": self.engine_steps,
            "slot_utilization": self.busy_slot_steps
            / max(1, self.engine_steps * self.batch_size),
            "queued": len(self.queue),
            "shed_queue_full": self.shed_counts.get("queue_full", 0),
            "shed_deadline": self.shed_counts.get("deadline", 0),
            "shed_node_down": self.shed_counts.get("node_down", 0),
            "cache_recycles": self.cache_recycles,
            "mean_queue_depth": self.queue_depth_sum / max(1, self.engine_steps),
            "max_queue_depth": self.queue_depth_max,
            **latency_percentiles(self.completed),
        }

    def run(self, max_engine_steps: int = 10_000) -> dict:
        """Standalone drain: decode until queue and slots are empty."""
        t0 = time.perf_counter()
        while (self.queue or any(s is not None for s in self.slots)) and (
            self.engine_steps < max_engine_steps
        ):
            self.step()
        dt = time.perf_counter() - t0
        out = self.stats()
        out["tokens_per_sec"] = out["generated_tokens"] / max(dt, 1e-9)
        return out


def standalone_requests(num: int, vocab_size: int, max_new: int, seed: int) -> list:
    """The standalone demo's requests: prompts of 4-23 tokens drawn from
    ``np.random.default_rng(seed)``."""
    rng = np.random.default_rng(seed)
    reqs = []
    for rid in range(num):
        plen = int(rng.integers(4, 24))
        reqs.append(Request(
            rid=rid,
            prompt=rng.integers(0, vocab_size, plen).astype(np.int32),
            max_new_tokens=max_new,
        ))
    return reqs


def build_route_engine(
    graph,
    method: str,
    load: np.ndarray,
    *,
    mhlj_params=None,
    law_kwargs: Optional[dict] = None,
    engine_kwargs: Optional[dict] = None,
    device="cuda",
):
    """The routing :class:`~repro_torch.core.engine.WalkEngine` through the
    trainer seam (``trainer._setup_method`` and ``_build_engine``).

    Any name of ``trainer.METHODS`` works: the per-node request ``load``
    stands in for the Lipschitz vector the laws weight by
    (``RegressionData.lipschitz = load``, features ``sqrt(load / 2)``), so
    ``importance``/``mhlj`` target pi ∝ load, ``uniform`` ignores the skew
    and ``simple`` follows degrees.  Returns ``(engine, p_j)``, ``p_j`` the
    law's jump probability (0 for the laws without jumps).
    """
    load = np.asarray(load, np.float64)
    if load.shape != (graph.n,) or (load <= 0).any():
        raise ValueError(f"load must be a positive ({graph.n},) vector")
    data = RegressionData(
        features=np.sqrt(load / 2.0)[:, None],
        targets=np.zeros(graph.n),
        x_star=np.zeros(1),
        lipschitz=load,
        high_variance_mask=np.zeros(graph.n, bool),
    )
    row_probs, _w, p_j_sched, p_d, r, _uw = trainer_mod._setup_method(
        method, graph, data, mhlj_params, None, 1, law_kwargs
    )
    engine = trainer_mod._build_engine(
        graph, p_d, r, row_probs, engine_kwargs, device
    )
    return engine, float(p_j_sched[0])


def _faulted_advance(fleet, p_j, fmodel, fstate, *, generator=None,
                     uniforms=None, fault_uniforms=None,
                     rescue_uniforms=None):
    """One fault-aware tick: the fault process advances first (the training
    loop's order), then the fleet takes one liveness-masked step; the
    returned state carries the engine's blocked counters forward so
    patience accrues across ticks.  Returns ``(fleet, fault_state,
    live_mask, aux)``."""
    fstate = fmodel.advance(fstate, uniforms=fault_uniforms,
                            generator=generator)
    fleet, _hops, aux = fleet.advance(
        uniforms=uniforms, generator=generator, p_j=p_j,
        faults=(fmodel, fstate), rescue_uniforms=rescue_uniforms,
    )
    fstate = dataclasses.replace(fstate, blocked=aux["blocked_steps"])
    return fleet, fstate, fmodel.live_mask(fstate), aux


class ServeSimulator:
    """Requests as nodes on the graph, walkers as the routing fabric.

    Per tick: (1) arrivals (Poisson, or the next rows of ``arrival_trace``)
    land at nodes drawn ∝ ``load`` and join that node's pending deque; (2)
    under faults the fault process advances; the W-walker fleet takes one
    batched step and its positions are read on the host and logged; (3)
    each walker not on a dead node picks up to ``pickup`` pending requests
    at its node and submits them (queue full and deadline sheds, each
    exactly once); (4) the serve engine takes one decode step.
    ``metrics()`` has the reference's keys: requests/s, queue depth, slot
    occupancy, p50/p95/p99 ticks, walk-steps/s, the visit Herfindahl and
    top-k share (``core.entrapment.occupancy_concentration``) and the
    fault telemetry (all zeros without a fault model).

    ``method="heterogeneity"`` defaults its pi to ``load / load.sum()``, so
    the dense (n, n) dissimilarity is never built on a serving graph.

    Faults (``fault_model=``): the fleet step is liveness-masked (blocked
    walkers accrue patience and take Lévy rescues onto the live set),
    walkers on dead nodes pick nothing up, pending requests at a node down
    ``relocate_after`` ticks move to a uniform live node (arrival order
    kept, counted in ``relocated_requests``), and an expiry observed at a
    down node sheds as ``"node_down"``.

    The route engine and the fault state live on ``device`` (default: the
    serve engine's).  The walk draws from ``self.generator``, seeded with
    ``seed`` on that device, unless :meth:`inject` gave it per-tick
    streams.  ``tick_seconds`` accumulates each tick's host-clock
    split: ``route`` (the fault process, the fleet step and the read of
    the positions), ``host`` (arrivals, pickup, relocation) and ``decode``
    (the serve engine's step).
    """

    def __init__(
        self,
        graph,
        serve_engine: ServeEngine,
        *,
        method: str = "mhlj",
        num_walkers: int = 64,
        load: Optional[np.ndarray] = None,
        rate: float = 1.0,
        pickup: int = 4,
        deadline_ticks: Optional[int] = None,
        prompt_len=(4, 16),
        max_new_tokens: int = 8,
        mhlj_params=None,
        law_kwargs: Optional[dict] = None,
        engine_kwargs: Optional[dict] = None,
        seed: int = 0,
        fault_model: Optional[FaultModel] = None,
        relocate_after: int = 3,
        arrival_trace: Optional[np.ndarray] = None,
        device=None,
    ):
        self.graph = graph
        self.n = int(graph.n)
        self.engine = serve_engine
        self.method = method
        dev = torch.device(serve_engine.device if device is None else device)
        if load is None:
            load = np.asarray(graph.degrees, np.float64)
        self.load = np.asarray(load, np.float64)
        if method == "heterogeneity" and not (law_kwargs and "pi" in law_kwargs):
            law_kwargs = {**(law_kwargs or {}), "pi": self.load / self.load.sum()}
        self._pop_cdf = np.cumsum(self.load / self.load.sum())
        self.route_engine, self.p_j = build_route_engine(
            graph, method, self.load,
            mhlj_params=mhlj_params, law_kwargs=law_kwargs,
            engine_kwargs=engine_kwargs, device=dev,
        )
        self.device = self.route_engine.device
        self.num_walkers = num_walkers
        self.fleet = WalkFleet.create(self.route_engine, num_walkers, seed=seed)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._streams: Optional[dict] = None
        self._rng = np.random.default_rng(seed + 1)
        # the fault machinery, dormant (and drawing nothing) without a model
        self.fault_model = (None if fault_model is None
                            else fault_model.to(self.device))
        self.relocate_after = int(relocate_after)
        self._fault_state = (
            None if fault_model is None
            else self.fault_model.init_state(self.n, num_walkers,
                                             device=self.device)
        )
        self._relocate_rng = np.random.default_rng(seed + 2)
        self._down_now: set = set()
        self.down_since: Dict[int, int] = {}
        self.rescues = 0
        self.blocked_steps = 0
        self.down_node_ticks = 0
        self.relocated = 0
        # trace-driven load (replaces the Poisson generator when set)
        if arrival_trace is not None:
            arr = np.asarray(arrival_trace, dtype=np.int64)
            if arr.ndim != 2 or arr.shape[1] != 3:
                raise ValueError(
                    "arrival_trace must be (k, 3) rows of (tick, node, "
                    f"prompt_len); got shape {arr.shape}"
                )
            arrival_trace = arr[np.argsort(arr[:, 0], kind="stable")]
        self._trace = arrival_trace
        self._trace_pos = 0
        self._draining = False
        self.arrival_log: List[tuple] = []
        self.rate = rate
        self.pickup = pickup
        self.deadline_ticks = deadline_ticks
        self.prompt_len = prompt_len
        self.max_new_tokens = max_new_tokens
        self.pending: Dict[int, deque] = {}
        self.pending_count = 0
        self.visits: List[np.ndarray] = []
        self.offered = 0
        self.picked_up = 0
        self.walk_steps = 0
        self.ticks = 0
        self._next_rid = 0
        self._wall = 0.0
        self.tick_seconds = {"route": 0.0, "host": 0.0, "decode": 0.0}

    # -- the walk's randomness ----------------------------------------------
    def _stream_shapes(self) -> dict:
        """Per-tick shape of each stream this simulator's walk consumes."""
        w, fm = self.num_walkers, self.fault_model
        shapes = {"uniforms": (w, 3 + self.route_engine.r)}
        if fm is not None and fm.markov:
            shapes["fault_uniforms"] = (self.n,)
        if fm is not None and fm.rescue:
            shapes["rescue_uniforms"] = (w,)
        return shapes

    def draw_streams(self, ticks: int, generator: torch.Generator) -> dict:
        """``ticks`` ticks of the streams a generator-driven run draws, in
        its order (per tick: Markov, walk block, rescue), as float32
        tensors on this simulator's device with a leading tick axis; what
        :meth:`inject` takes."""
        shapes = self._stream_shapes()
        out = {k: [] for k in shapes}
        for _ in range(ticks):
            if "fault_uniforms" in shapes:
                out["fault_uniforms"].append(torch.rand(
                    shapes["fault_uniforms"], generator=generator,
                    device=self.device))
            out["uniforms"].append(draw_uniforms(
                self.num_walkers, self.route_engine.r, self.p_j, generator,
                self.device))
            if "rescue_uniforms" in shapes:
                out["rescue_uniforms"].append(torch.rand(
                    shapes["rescue_uniforms"], generator=generator,
                    device=self.device))
        return {k: torch.stack(v) if v else torch.empty(
                    (0, *shapes[k]), device=self.device)
                for k, v in out.items()}

    def inject(self, streams: dict) -> "ServeSimulator":
        """Drive the walk from ``streams`` in place of the generator: a dict
        with ``uniforms`` (T, W, 3 + r), slot 0 already the jump flag,
        ``fault_uniforms`` (T, n) when a fault rate is positive and
        ``rescue_uniforms`` (T, W) when the rescue is on (other keys must
        be None or absent).  Tick ``t`` takes row ``t`` of each."""
        shapes = self._stream_shapes()
        given = {k: v for k, v in streams.items() if v is not None}
        if set(given) != set(shapes):
            raise ValueError(f"this simulator's walk consumes the streams "
                             f"{sorted(shapes)}; got {sorted(given)}")
        out = {}
        for k, v in given.items():
            v = torch.as_tensor(v, dtype=torch.float32, device=self.device)
            if v.ndim != 1 + len(shapes[k]) or tuple(v.shape[1:]) != shapes[k]:
                dims = ", ".join(map(str, shapes[k]))
                raise ValueError(f"{k} must be (T, {dims}), got "
                                 f"{tuple(v.shape)}")
            out[k] = v
        if len({v.shape[0] for v in out.values()}) != 1:
            raise ValueError("the streams must hold the same number of ticks")
        self._streams = out
        return self

    def _draws(self, t: int) -> dict:
        """The walk's randomness for tick ``t``: injected rows or the
        generator."""
        if self._streams is None:
            return {"generator": self.generator}
        held = self._streams["uniforms"].shape[0]
        if t >= held:
            raise ValueError(f"the injected streams hold {held} ticks; tick "
                             f"{t} needs more")
        return {k: v[t] for k, v in self._streams.items()}

    # -- workload -----------------------------------------------------------
    def offer(self, req: Request) -> None:
        """Pin ``req`` to its node's pending queue (arrival, not admission)."""
        if not (0 <= req.node < self.n):
            raise ValueError(
                f"request {req.rid}: node {req.node} outside [0, {self.n})"
            )
        need = len(req.prompt) + req.max_new_tokens
        if need > self.engine.cache_len - 1:
            # the engine's cache-budget reject at the door, so an impossible
            # request never waits for a walker first
            raise ValueError(
                f"request {req.rid}: prompt+max_new ({need}) exceeds the "
                f"cache budget (cache_len - 1 = {self.engine.cache_len - 1})"
            )
        self.pending.setdefault(req.node, deque()).append(req)
        self.pending_count += 1
        self.offered += 1

    def _offer_generated(self, t: int, node: int, plen: int) -> None:
        """One synthetic arrival: prompt tokens from the workload RNG."""
        self.offer(
            Request(
                rid=self._next_rid,
                prompt=self._rng.integers(
                    0, self.engine.cfg.vocab_size, plen
                ).astype(np.int32),
                max_new_tokens=self.max_new_tokens,
                node=node,
                deadline=(
                    None
                    if self.deadline_ticks is None
                    else t + self.deadline_ticks
                ),
                submit_tick=t,
            )
        )
        self.arrival_log.append((t, node, plen))
        self._next_rid += 1

    def _arrivals(self, t: int) -> None:
        if self._trace is not None:
            if self._draining:
                return
            tr, i = self._trace, self._trace_pos
            while i < tr.shape[0] and tr[i, 0] <= t:
                if tr[i, 0] == t:
                    self._offer_generated(t, int(tr[i, 1]), int(tr[i, 2]))
                i += 1
            self._trace_pos = i
            return
        k = int(self._rng.poisson(self.rate))
        if k == 0:
            return
        nodes = np.searchsorted(self._pop_cdf, self._rng.random(k))
        lo, hi = self.prompt_len
        for v in nodes:
            plen = int(self._rng.integers(lo, hi + 1))
            self._offer_generated(t, int(v), plen)

    # -- fault handling -----------------------------------------------------
    def _advance_faults(self, draws: dict) -> np.ndarray:
        """Advance the fault process and the fleet one tick; returns the
        live mask on the host and adds the tick's telemetry."""
        self.fleet, self._fault_state, live, aux = _faulted_advance(
            self.fleet, self.p_j, self.fault_model, self._fault_state,
            **draws,
        )
        live_np = live.cpu().numpy()
        rescued, blocked = torch.stack(
            [aux["rescued"].sum(), aux["fault_blocked"].sum()]).tolist()
        self.rescues += int(rescued)
        self.blocked_steps += int(blocked)
        return live_np

    def _degrade(self, t: int, live_np: np.ndarray) -> None:
        """Update the engine's ``down_nodes`` view and per-node downtime,
        then relocate pending work off nodes down past the backoff."""
        self.down_node_ticks += int((~live_np).sum())
        self._down_now = set(np.nonzero(~live_np)[0].tolist())
        self.engine.down_nodes = self._down_now
        for v in [u for u in self.down_since if u not in self._down_now]:
            del self.down_since[v]
        for v in self._down_now:
            self.down_since.setdefault(v, t)
        self._relocate_pending(t, live_np)

    def _relocate_pending(self, t: int, live_np: np.ndarray) -> None:
        """Re-queue pending requests off nodes down ≥ ``relocate_after``
        ticks onto a uniformly drawn live node (arrival order kept)."""
        live_ids = np.nonzero(live_np)[0]
        if live_ids.size == 0:
            return  # total failure: nowhere to go, requests wait or expire
        stale = [
            v for v in list(self.pending)
            if v in self._down_now
            and t - self.down_since.get(v, t) >= self.relocate_after
        ]
        for v in stale:
            dq = self.pending.pop(v)
            tgt = int(live_ids[int(self._relocate_rng.integers(live_ids.size))])
            for req in dq:
                req.node = tgt
            self.relocated += len(dq)
            self.pending.setdefault(tgt, deque()).extend(dq)

    # -- the tick loop ------------------------------------------------------
    def tick(self) -> None:
        t = self.ticks
        t0 = time.perf_counter()
        self._arrivals(t)
        t1 = time.perf_counter()
        draws = self._draws(t)
        live_np = None
        if self.fault_model is None:
            self.fleet, _hops = self.fleet.advance(p_j=self.p_j, **draws)
        else:
            live_np = self._advance_faults(draws)
        where = self.fleet.nodes.cpu().numpy()  # pickup is host logic
        t2 = time.perf_counter()
        if live_np is not None:
            self._degrade(t, live_np)
        self.visits.append(where.copy())
        self.walk_steps += self.num_walkers
        for v in where.tolist():
            if v in self._down_now:
                continue  # a walker parked on a dead node serves nothing
            dq = self.pending.get(v)
            if not dq:
                continue
            for _ in range(self.pickup):
                if not dq:
                    break
                req = dq.popleft()
                self.pending_count -= 1
                if req.deadline is not None and t > req.deadline:
                    self.engine.shed(req, "deadline")
                    continue
                if self.engine.submit(req, tick=t):
                    self.picked_up += 1
            if not dq:
                self.pending.pop(v, None)
        t3 = time.perf_counter()
        self.engine.step(tick=t)
        self.ticks += 1
        secs = self.tick_seconds
        secs["route"] += t2 - t1
        secs["host"] += (t1 - t0) + (t3 - t2)
        secs["decode"] += time.perf_counter() - t3

    def _expire_pending(self) -> None:
        """Shed deadline-expired requests still waiting at their node;
        expiry observed at a currently down node sheds as ``node_down``."""
        t = self.ticks
        for v in list(self.pending):
            keep: deque = deque()
            dq = self.pending.pop(v)
            while dq:
                req = dq.popleft()
                if req.deadline is not None and t > req.deadline:
                    self.engine.shed(
                        req,
                        "node_down" if req.node in self._down_now
                        else "deadline",
                    )
                    self.pending_count -= 1
                else:
                    keep.append(req)
            if keep:
                self.pending[v] = keep

    def run(self, num_ticks: int, drain_ticks: int = 0) -> dict:
        """``num_ticks`` with arrivals, then ``drain_ticks`` without."""
        t0 = time.perf_counter()
        for _ in range(num_ticks):
            self.tick()
        rate, self.rate = self.rate, 0.0
        self._draining = True
        try:
            for _ in range(drain_ticks):
                self.tick()
        finally:
            self.rate = rate
            self._draining = False
        self._expire_pending()
        self._wall += time.perf_counter() - t0
        return self.metrics()

    # -- telemetry ----------------------------------------------------------
    def metrics(self) -> dict:
        eng = self.engine.stats()
        if self.visits:
            traj = np.concatenate(self.visits)
            conc = occupancy_concentration(traj, self.n, topk=min(8, self.n))
        else:
            conc = {"herfindahl": 0.0, "topk_share": 0.0}
        wall = max(self._wall, 1e-9)
        return {
            "ticks": self.ticks,
            "offered": self.offered,
            "picked_up": self.picked_up,
            "pending_left": self.pending_count,
            "completed": eng["completed"],
            "generated_tokens": eng["generated_tokens"],
            "queued_left": eng["queued"],
            "shed_queue_full": eng["shed_queue_full"],
            "shed_deadline": eng["shed_deadline"],
            "shed_node_down": eng["shed_node_down"],
            "cache_recycles": eng["cache_recycles"],
            "slot_occupancy": eng["slot_utilization"],
            "mean_queue_depth": eng["mean_queue_depth"],
            "max_queue_depth": eng["max_queue_depth"],
            "requests_per_sec": eng["completed"] / wall,
            "tokens_per_sec": eng["generated_tokens"] / wall,
            "walk_steps_per_sec": self.walk_steps / wall,
            "p50_ticks": eng["p50_ticks"],
            "p95_ticks": eng["p95_ticks"],
            "p99_ticks": eng["p99_ticks"],
            "herfindahl": conc["herfindahl"],
            "topk_share": conc["topk_share"],
            # the fault telemetry: all zeros without a fault model, so the
            # schema is the same on every leg of a sweep
            "walker_rescues": self.rescues,
            "walker_blocked_steps": self.blocked_steps,
            "relocated_requests": self.relocated,
            "node_downtime_frac": (
                self.down_node_ticks / max(1, self.ticks * self.n)
            ),
        }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m", choices=sorted(ARCHITECTURES))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--nodes", type=int, default=2000,
                    help="graph size (ragged-layout Barabasi-Albert)")
    ap.add_argument("--ba-m", type=int, default=3,
                    help="Barabasi-Albert attachment parameter")
    ap.add_argument("--walkers", type=int, default=32,
                    help="routing fleet size W")
    ap.add_argument("--method", default="mhlj", choices=list(trainer_mod.METHODS),
                    help="routing law (the trainer METHODS seam)")
    ap.add_argument("--rate", type=float, default=1.0,
                    help="mean Poisson arrivals per tick")
    ap.add_argument("--ticks", type=int, default=200)
    ap.add_argument("--drain", type=int, default=100,
                    help="extra arrival-free ticks to drain the system")
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--pickup", type=int, default=4,
                    help="max requests a walker picks up per visit")
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission-queue bound (backpressure)")
    ap.add_argument("--deadline", type=int, default=None,
                    help="per-request admission deadline in ticks")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--crash-rate", type=float, default=0.0,
                    help="per-tick node crash probability (0 = no faults)")
    ap.add_argument("--recovery-rate", type=float, default=0.0,
                    help="per-tick dead-node recovery probability")
    ap.add_argument("--patience", type=int, default=3,
                    help="consecutive blocked steps before a Lévy rescue")
    ap.add_argument("--no-rescue", action="store_true",
                    help="disable the Lévy-jump rescue (blocked walkers "
                    "just wait)")
    ap.add_argument("--relocate-after", type=int, default=3,
                    help="ticks a node stays down before its pending "
                    "requests are re-queued at a live node")
    ap.add_argument("--trace", default=None,
                    help="replay arrivals from a recorded trace file "
                    "instead of the Poisson generator")
    ap.add_argument("--record-trace", default=None,
                    help="write this run's arrival trace to a file "
                    "(replayable via --trace)")
    ap.add_argument("--standalone", action="store_true",
                    help="skip graph routing: direct-submit --requests "
                    "requests to the slot engine")
    ap.add_argument("--requests", type=int, default=8,
                    help="standalone mode: number of direct-submitted requests")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = reduced(get_arch(args.arch)) if args.scale == "smoke" else get_arch(args.arch)
    engine = ServeEngine(
        cfg, args.batch, args.cache_len, seed=args.seed,
        max_queue=args.max_queue, device=args.device,
    )

    if args.standalone:
        for req in standalone_requests(args.requests, cfg.vocab_size,
                                       args.max_new, args.seed):
            engine.submit(req)
        stats = engine.run()
        for k, v in stats.items():
            print(f"{k}: {v:.4g}" if isinstance(v, float) else f"{k}: {v}")
        return 0 if stats["completed"] == args.requests else 1

    graph = barabasi_albert(args.nodes, args.ba_m, seed=args.seed, layout="ragged")
    fault_model = None
    if args.crash_rate > 0.0:
        fault_model = FaultModel(
            crash_rate=args.crash_rate,
            recovery_rate=args.recovery_rate,
            patience=args.patience,
            rescue=not args.no_rescue,
        )
    sim = ServeSimulator(
        graph,
        engine,
        method=args.method,
        num_walkers=args.walkers,
        rate=args.rate,
        pickup=args.pickup,
        deadline_ticks=args.deadline,
        max_new_tokens=args.max_new,
        seed=args.seed,
        fault_model=fault_model,
        relocate_after=args.relocate_after,
        arrival_trace=(
            load_arrival_trace(args.trace) if args.trace else None
        ),
    )
    metrics = sim.run(args.ticks, drain_ticks=args.drain)
    if args.record_trace:
        save_arrival_trace(args.record_trace, sim.arrival_log)
    for k, v in metrics.items():
        print(f"{k}: {v:.4g}" if isinstance(v, float) else f"{k}: {v}")
    return 0 if metrics["completed"] > 0 else 1


if __name__ == "__main__":
    raise SystemExit(main())
