"""Walk-routed serving throughput, one workload per routing law: the port of
the reference's ``benchmarks/serve_throughput.py``.

Requests arrive at nodes of a ragged Barabási–Albert graph (traffic skewed
∝ degree, so demand sits on the hubs), a W-walker fleet routes them with
one batched ``walk_transition_ragged`` step per tick (the law chosen
through the trainer's METHODS seam), and a slot-based ``ServeEngine`` with
a bounded admission queue and per-request deadlines decodes them on the
reduced mamba2-370m.  Per law: requests/s, p50/p95/p99 ticks, queue
depth, slot occupancy, the sheds and the visit Herfindahl/top-k share.

The reference's settings, seeds and ``derived`` keys
(``ba_{law}_herfindahl``, ``ba_{law}_p99_ticks``,
``ba_{law}_requests_per_sec``); the values are wall-clock or statistical,
so only their presence is gated.  The port writes no file under
``results/``.
"""
from __future__ import annotations

import time
from typing import Callable, Optional

from repro_torch.configs import get_arch, reduced
from repro_torch.core.graphs import barabasi_albert
from repro_torch.launch.serve import ServeEngine, ServeSimulator

NAME = "serve_throughput"
PAPER_CLAIM = (
    "Serving closes the loop: requests pinned to nodes of a hub-heavy "
    "graph are routed by walker fleets, and the chain law's entrapment "
    "trade-off (Herfindahl) becomes a requests/s + p99-latency trade-off."
)

# (label, trainer method, law_kwargs); heterogeneity's pi defaults to the
# load inside ServeSimulator, so no (n, n) dissimilarity is built
LAWS = (
    ("simple", "simple", None),
    ("uniform", "uniform", None),
    ("importance", "importance", None),
    ("mhlj", "mhlj", None),
    ("heterogeneity", "heterogeneity", None),
    ("private_g0.5", "private", {"gamma": 0.5}),
)

# one scenario per scale: graph size, fleet size, traffic and decode budget
SCALES = {
    "smoke": dict(
        n=384, m=3, walkers=24, ticks=90, drain=30, rate=1.0, pickup=4,
        batch=4, cache_len=64, max_queue=32, deadline=80,
        prompt_len=(4, 10), max_new=6,
    ),
    "quick": dict(
        n=20_000, m=3, walkers=128, ticks=400, drain=150, rate=1.5, pickup=4,
        batch=8, cache_len=128, max_queue=64, deadline=300,
        prompt_len=(4, 16), max_new=8,
    ),
    "full": dict(
        n=100_000, m=3, walkers=512, ticks=1500, drain=500, rate=2.0,
        pickup=4, batch=8, cache_len=192, max_queue=128, deadline=1000,
        prompt_len=(4, 24), max_new=12,
    ),
}


def run(
    quick: bool = False,
    scale: Optional[str] = None,
    *,
    device="cuda",
    blocks: Optional[Callable] = None,
) -> dict:
    """Every law of :data:`LAWS` at ``scale``.  ``blocks(*, law, seed,
    ticks, walkers, n, r, p_j)`` may return a law's walk streams (what
    :meth:`ServeSimulator.inject` takes) or None to let the law draw from
    its generator.  Beside the reference's keys, ``route_setup_s`` holds
    each law's simulator set-up seconds (the host rows and the device
    CDF)."""
    scale = scale or ("quick" if quick else "full")
    p = SCALES[scale]
    graph = barabasi_albert(p["n"], p["m"], seed=0, layout="ragged")
    cfg = reduced(get_arch("mamba2-370m"))
    # one model for the whole sweep: each law reuses the engine via reset()
    engine = ServeEngine(cfg, p["batch"], p["cache_len"], seed=0,
                         max_queue=p["max_queue"], device=device)
    ticks = p["ticks"] + p["drain"]
    out = {
        "scale": scale,
        "graph": graph.name,
        "n": graph.n,
        "walkers": p["walkers"],
        "ticks": ticks,
        "claim": PAPER_CLAIM,
        "laws": [law[0] for law in LAWS],
        "route_setup_s": {},
    }
    derived: dict = {}
    for label, method, law_kwargs in LAWS:
        t0 = time.perf_counter()
        sim = ServeSimulator(
            graph,
            engine.reset(),
            method=method,
            num_walkers=p["walkers"],
            rate=p["rate"],
            pickup=p["pickup"],
            deadline_ticks=p["deadline"],
            prompt_len=p["prompt_len"],
            max_new_tokens=p["max_new"],
            law_kwargs=law_kwargs,
            seed=0,
        )
        out["route_setup_s"][label] = time.perf_counter() - t0
        streams = None if blocks is None else blocks(
            law=label, seed=0, ticks=ticks, walkers=p["walkers"], n=graph.n,
            r=sim.route_engine.r, p_j=sim.p_j,
        )
        if streams is not None:
            sim.inject(streams)
        metrics = sim.run(p["ticks"], drain_ticks=p["drain"])
        out[label] = metrics
        # presence says the law still serves; magnitudes are not gated
        derived[f"ba_{label}_herfindahl"] = metrics["herfindahl"]
        derived[f"ba_{label}_p99_ticks"] = metrics["p99_ticks"]
        derived[f"ba_{label}_requests_per_sec"] = metrics["requests_per_sec"]
    out["derived"] = derived
    return out


def run_smoke(*, device="cuda", blocks=None) -> dict:
    """The reference's tiny tier: every law serves a toy workload end to
    end (arrivals, fleet pickup, slot decode, shed accounting)."""
    return run(scale="smoke", device=device, blocks=blocks)
