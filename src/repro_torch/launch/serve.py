"""Slot-based continuous batching over a model's cached decode step.

:class:`ServeEngine` is the JAX package's ``launch/serve.py`` engine on
the port's models: every slot advances one token per engine step, either
prefilling (consuming its prompt) or generating (feeding back its own
greedy argmax).  The scheduling contract is the reference's:

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

Latency is counted in engine ticks (``latency_percentiles``).  The
walk-routed simulator of the reference (``ServeSimulator``,
``build_route_engine``, the arrival-trace I/O) is not ported yet.

    python -m repro_torch.launch.serve --arch mamba2-370m --scale full --standalone
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.configs import ARCHITECTURES, get_arch, reduced
from repro_torch.models.factory import build_model

__all__ = ["Request", "ServeEngine", "latency_percentiles", "main"]

# what the routed mode still needs, and where the ROADMAP lists it
_ROUTED_NOT_PORTED = (
    "the walk-routed mode needs ServeSimulator, build_route_engine and the "
    "arrival-trace I/O (ROADMAP Queue 1 item 11), which need "
    "WalkFleet.advance, faults and entrapment (items 4, 5, 7); run with "
    "--standalone"
)


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


class ServeEngine:
    """Slot-based continuous batching (contract in the module docstring).

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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="mamba2-370m", choices=sorted(ARCHITECTURES))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "full"])
    ap.add_argument("--standalone", action="store_true",
                    help="direct-submit --requests requests to the slot "
                    "engine (the only mode ported so far)")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--batch", type=int, default=4, help="decode slots")
    ap.add_argument("--cache-len", type=int, default=256)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-queue", type=int, default=64,
                    help="admission-queue bound (backpressure)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if not args.standalone:
        raise NotImplementedError(_ROUTED_NOT_PORTED)

    cfg = reduced(get_arch(args.arch)) if args.scale == "smoke" else get_arch(args.arch)
    engine = ServeEngine(
        cfg, args.batch, args.cache_len, seed=args.seed,
        max_queue=args.max_queue, device=args.device,
    )
    for req in standalone_requests(args.requests, cfg.vocab_size, args.max_new,
                                   args.seed):
        engine.submit(req)
    stats = engine.run()
    for k, v in stats.items():
        print(f"{k}: {v:.4g}" if isinstance(v, float) else f"{k}: {v}")
    return 0 if stats["completed"] == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
