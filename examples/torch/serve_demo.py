"""Serving demo: walk-routed requests on a hub-heavy graph, per routing
law, on the port.

Spins up ONE ServeEngine (reduced mamba2-370m: SSM decode, O(1) state)
and, for each routing law, a ServeSimulator on a ragged-layout
Barabasi-Albert graph: requests arrive at nodes with degree-proportional
skew (demand concentrates on the hubs), a small walker fleet picks them
up and feeds the slot scheduler, and the table shows the serving numbers
next to the entrapment telemetry: requests/s, p50/p99 latency in ticks,
shed counters (backpressure + deadlines) and the per-node visit
Herfindahl.  The model and the walks run on the card unless
``--device cpu``; ``--small`` serves 40 ticks (+20 to drain) on 256 nodes
in place of 150 (+50) on 512.  The full sweep is
``repro_torch.paper.serve_throughput``.

Run:  PYTHONPATH=src python examples/torch/serve_demo.py [--device cpu] [--small]
"""
import argparse

from repro_torch.configs import get_arch, reduced
from repro_torch.core.graphs import barabasi_albert
from repro_torch.launch.serve import ServeEngine, ServeSimulator

LAWS = (
    ("simple", "simple", None),
    ("uniform", "uniform", None),
    ("mhlj", "mhlj", None),
    ("private_g0.5", "private", {"gamma": 0.5}),
)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true",
                    help="40 ticks (+20 drain) on 256 nodes")
    args = ap.parse_args(argv)
    n, ticks, drain = (256, 40, 20) if args.small else (512, 150, 50)
    graph = barabasi_albert(n, 3, seed=0, layout="ragged")
    cfg = reduced(get_arch("mamba2-370m"))
    # one model build; each law resets the serving state
    engine = ServeEngine(cfg, batch_size=4, cache_len=64, max_queue=32,
                         device=args.device)
    print(f"graph: {graph.name} (n={graph.n}), walkers: 32, "
          f"arch: {cfg.name} (reduced), device={args.device}")
    print(f"{'law':<14} {'served':>9} {'req/s':>7} {'p50':>5} {'p99':>6} "
          f"{'shed(q/ddl)':>11} {'herfindahl':>10}")
    out = {}
    for label, method, law_kwargs in LAWS:
        sim = ServeSimulator(
            graph, engine.reset(), method=method, num_walkers=32,
            rate=1.5, pickup=4, deadline_ticks=120,
            prompt_len=(4, 12), max_new_tokens=6,
            law_kwargs=law_kwargs, seed=0,
        )
        m = sim.run(ticks, drain_ticks=drain)
        out[label] = m
        print(f"{label:<14} {m['completed']:>4}/{m['offered']:<4} "
              f"{m['requests_per_sec']:>7.1f} {m['p50_ticks']:>5.0f} "
              f"{m['p99_ticks']:>6.1f} "
              f"{m['shed_queue_full']:>5}/{m['shed_deadline']:<5} "
              f"{m['herfindahl']:>10.4f}")
    return out


if __name__ == "__main__":
    main()
