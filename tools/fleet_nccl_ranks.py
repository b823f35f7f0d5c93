"""Phase 3's trainer as a walker fleet over several cards, one process a card.

    PYTHONPATH=src python tools/fleet_nccl_ranks.py            # every visible GPU, NCCL
    PYTHONPATH=src python tools/fleet_nccl_ranks.py --device cpu --ranks 4 --nodes 3000 --steps 40

``run_rw_sgd_multi("mhlj", ...)`` on ``barabasi_albert(nodes, 3)`` (ragged)
with ``make_heterogeneous_regression(nodes, dim=6, ...)``, W walks,
avg_every=50 (``chip_smoke.py`` phase 3's trainer), under a
``make_walker_mesh()`` of P ranks: each rank holds W/P walks, its loop
captured in CUDA graphs with the NCCL all-reduces inside.  Rank 0 then
runs the same trainer unsharded on its card and holds the mesh run to it:
walks bit for bit, ``mse``/``avg_mse`` at rtol 1e-5 and ``x_final`` at
rtol 1e-4 / atol 1e-6 (the reference's tolerances for its sharded
fleet).  Prints one line a rank (replayed ms/step, ragged launches, one
eager all-reduce of a ``(6,)`` float32 vector) and a JSON summary last;
exits non-zero when a check fails.  ``--device cpu`` runs the same over
gloo on the CPU (a rehearsal: no capture, no launch counts).
"""
from __future__ import annotations

import argparse
import json
import os
import socket
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "src"))


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _trainer(args, dev, mesh):
    """The trainer's result, its loop's seconds and the ``ScanStats`` of
    its loop; ``mesh=None`` runs it unsharded."""
    from repro_torch.core import scan as scan_mod
    from repro_torch.core.graphs import barabasi_albert
    from repro_torch.core.transition import MHLJParams
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import run_rw_sgd_multi

    g = barabasi_albert(args.nodes, 3, seed=0, layout="ragged")
    data = make_heterogeneous_regression(args.nodes, dim=6, sigma_high_sq=100.0,
                                         p_high=0.03, seed=7, x_star_scale=3.0)
    stats, scan = [], scan_mod.scan

    def recording(*a, **k):
        _sync(dev)
        t0 = time.perf_counter()
        out = scan(*a, **k)
        _sync(dev)
        stats.append((out[2], time.perf_counter() - t0))
        return out

    scan_mod.scan = recording
    try:
        res = run_rw_sgd_multi(
            "mhlj", g, data, float(0.3 / data.lipschitz.mean()), args.steps,
            args.walks, mhlj_params=MHLJParams(0.1, 0.5, 3), avg_every=50,
            seed=0, device=dev, **({} if mesh is None else {"mesh": mesh}))
    finally:
        scan_mod.scan = scan
    return res, stats[0]


def _allreduce_ms(mesh, dev, iters: int = 200) -> float:
    import torch.distributed as dist

    group = mesh.get_group("data")
    x = torch.ones(6, device=dev)
    dist.all_reduce(x, group=group)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        dist.all_reduce(x, group=group)
    _sync(dev)
    return (time.perf_counter() - t0) * 1e3 / iters


def _rank(rank: int, world: int, port: int, args) -> None:
    import torch.distributed as dist

    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.launch.mesh import make_walker_mesh

    cuda = args.device == "cuda"
    if cuda:
        torch.cuda.set_device(rank)
        torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", rank) if cuda else torch.device("cpu")
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    dist.init_process_group(
        "nccl" if cuda else "gloo", init_method=f"tcp://localhost:{port}",
        world_size=world, rank=rank, **({"device_id": dev} if cuda else {}))
    try:
        mesh = make_walker_mesh(device_type=args.device)
        wt.walk_transition_ragged.launches = 0
        res, (stats, loop_s) = _trainer(args, dev, mesh)
        mine = {"rank": rank, "captured": stats.captured,
                "replayed_ms_per_step": (None if stats.replay_ms() is None
                                         else stats.replay_ms() / (args.steps - 1)),
                "loop_ms_per_step": loop_s * 1e3 / args.steps,
                "launches": wt.walk_transition_ragged.launches,
                "allreduce_ms": _allreduce_ms(mesh, dev),
                "card": torch.cuda.get_device_name(dev) if cuda else "cpu"}
        every = [None] * world
        dist.all_gather_object(every, mine)
        if rank == 0:
            plain, (pstats, plain_s) = _trainer(args, dev, None)
            checks = {
                "walks": bool(np.array_equal(res.update_nodes, plain.update_nodes)
                              and np.array_equal(res.transitions,
                                                 plain.transitions)),
                "mse": bool(np.allclose(res.mse, plain.mse, rtol=1e-5, atol=0)),
                "avg_mse": bool(np.allclose(res.avg_mse, plain.avg_mse,
                                            rtol=1e-5, atol=0)),
                "x_final": bool(np.allclose(res.x_final, plain.x_final,
                                            rtol=1e-4, atol=1e-6)),
            }
            unsharded = {"captured": pstats.captured,
                         "replayed_ms_per_step": (
                             None if pstats.replay_ms() is None
                             else pstats.replay_ms() / (args.steps - 1)),
                         "loop_ms_per_step": plain_s * 1e3 / args.steps}
            for r in every:
                print(f"rank {r['rank']} ({r['card']}): {args.walks // world} "
                      f"walks, captured {r['captured']}, replayed "
                      f"{r['replayed_ms_per_step']} ms/step, loop "
                      f"{r['loop_ms_per_step']:.5f} ms/step, "
                      f"{r['launches']} ragged launches, one all-reduce of "
                      f"(6,) float32 {r['allreduce_ms']:.5f} ms", flush=True)
            print(f"unsharded on rank 0's card: {unsharded}; checks {checks}",
                  flush=True)
            print(json.dumps({"ranks": every, "unsharded": unsharded,
                              "checks": checks, "walks": args.walks,
                              "steps": args.steps, "nodes": args.nodes}),
                  flush=True)
            if not all(checks.values()):
                raise AssertionError(f"the mesh run differs: {checks}")
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    ap.add_argument("--ranks", type=int, default=None,
                    help="processes (default: every visible GPU)")
    ap.add_argument("--nodes", type=int, default=100_000)
    ap.add_argument("--walks", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=500)
    args = ap.parse_args()
    if args.device == "cuda" and not torch.cuda.is_available():
        print("fleet_nccl_ranks: no CUDA device", file=sys.stderr)
        return 2
    world = args.ranks or (torch.cuda.device_count() if args.device == "cuda"
                           else 2)
    if args.device == "cuda" and world > torch.cuda.device_count():
        print(f"fleet_nccl_ranks: {world} ranks, {torch.cuda.device_count()} "
              "cards: NCCL takes one card a rank", file=sys.stderr)
        return 2
    if args.device == "cuda":  # each card's name and power limit; one build
        import subprocess

        from repro_torch.kernels import _build

        _build.build(["walk_transition_ragged"])

        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True, timeout=60).stdout.strip(), flush=True)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    import torch.multiprocessing as tmp

    tmp.start_processes(_rank, args=(world, port, args), nprocs=world,
                        join=True, start_method="spawn")
    return 0


if __name__ == "__main__":
    sys.exit(main())
