"""End-to-end decentralized training on the port.

Runs walk-orchestrated LLM training: a graph of data silos, MHLJ (or a
baseline) routing, per-silo token shards, the walk train step
(``repro_torch.walk_sgd.llm_trainer``), periodic checkpoints and metric
logging.  Training runs the models' plain PyTorch layers
(``use_kernels=False``, the configs' default): the CUDA kernels have no
backward, as the reference's Pallas kernels have none.

  python -m repro_torch.launch.train --arch qwen2.5-32b --scale smoke \\
      --steps 100 --method mhlj --device cpu

``--scale smoke`` trains the arch's reduced() variant; ``--scale custom``
takes explicit --layers/--d-model/...; ``--scale full`` the config's full
width and depth on one card.  ``--device`` defaults to ``cuda``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import time
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from repro_torch import optim
from repro_torch.configs import ARCHITECTURES, get_arch, reduced
from repro_torch.core import graphs as g_mod
from repro_torch.core import schedules as pj_schedules
from repro_torch.core.transition import MHLJParams
from repro_torch.data.lm_data import make_node_token_shards
from repro_torch.data.pipeline import NodeDataPipeline
from repro_torch.models.base import param_tree
from repro_torch.models.factory import build_model
from repro_torch.optim.base import leaves
from repro_torch.utils import checkpoint as ckpt
from repro_torch.walk_sgd.llm_trainer import (
    WalkContext,
    init_walk_state,
    make_train_step,
)

__all__ = ["GRAPHS", "run_training", "main"]

GRAPHS = {
    "ring": lambda n, seed: g_mod.ring(n),
    "grid": lambda n, seed: g_mod.grid2d(int(np.sqrt(n))),
    "watts_strogatz": lambda n, seed: g_mod.watts_strogatz(n, 4, 0.1, seed),
    "erdos_renyi": lambda n, seed: g_mod.erdos_renyi(n, 0.1, seed),
    "expander": lambda n, seed: g_mod.expander(n, 6, seed),
}


def run_training(
    cfg,
    *,
    graph_kind: str = "ring",
    n_silos: int = 16,
    method: str = "mhlj",
    steps: int = 100,
    batch_size: int = 4,
    seq_len: int = 128,
    lr: float = 3e-4,
    p_j: float = 0.1,
    p_d: float = 0.5,
    r: int = 3,
    anneal_pj: bool = False,
    online_lipschitz: bool = True,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    checkpoint_every: int = 0,
    resume: bool = False,
    log_every: int = 10,
    dtype: torch.dtype = torch.float32,
    device="cuda",
    init_params: Optional[dict] = None,
    uniforms=None,
    projections: Optional[Sequence[torch.Tensor]] = None,
    on_phase: Optional[Callable[[str], None]] = None,
) -> dict:
    """Train; returns the reference's keys: ``losses``, ``update_nodes``,
    ``transitions_per_update``, ``steps_per_sec``, ``params``,
    ``opt_state``, ``walk_state`` and ``final_lipschitz``.

    The model's weights are drawn from ``torch.Generator(device)`` seeded
    ``seed``, or carried from ``init_params`` (the reference's params
    pytree as numpy, through ``interop.model_from_reference_params``).
    The walk draws its blocks from its generator, or takes step ``t``'s
    ``(1, 3 + r)`` block from ``uniforms[t]`` (``(steps, 1, 3 + r)``, slot
    0 the jump flag); ``projections`` replace the fingerprint's draw.
    ``on_phase(name)`` is called at the top of each step (``"step"``),
    when its batch is on the device (``"host"``: the node read and the
    batch fetch) and at the train step's own phase ends
    (``make_train_step``).
    """
    device = torch.device(device)
    graph = GRAPHS[graph_kind](n_silos, seed)
    n_silos = graph.n
    data = make_node_token_shards(
        n_silos, cfg.vocab_size, shard_len=max(2048, (seq_len + 1) * 4), seed=seed
    )
    pipeline = NodeDataPipeline(data, batch_size, seq_len, seed=seed)

    if init_params is None:
        model = build_model(cfg, dtype, device=device,
                            generator=torch.Generator(device).manual_seed(seed))
    else:
        from repro_torch import interop

        model = interop.model_from_reference_params(cfg, init_params,
                                                    device=device)
    params = param_tree(model)
    optimizer = optim.adamw(lr)
    opt_state = optimizer.init(params)

    # method -> walk configuration (p_j=0 degrades MHLJ to plain MH-IS;
    # uniform Lipschitz degrades MH-IS to MH-uniform)
    if method == "mhlj":
        params_w = MHLJParams(p_j, p_d, r)
        lips0 = np.ones(n_silos, np.float32)
    elif method == "importance":
        params_w = MHLJParams(0.0, p_d, r)
        lips0 = np.ones(n_silos, np.float32)
    elif method == "uniform":
        params_w = MHLJParams(0.0, p_d, r)
        lips0 = np.ones(n_silos, np.float32)
        online_lipschitz = False  # keep L_v == 1 -> MH-uniform
    else:
        raise ValueError(f"unknown method {method!r}")

    walk = WalkContext.from_graph(graph, params_w,
                                  online_lipschitz=online_lipschitz,
                                  device=device)
    walk_state = init_walk_state(n_silos, lips0, v0=0, seed=seed,
                                 online=online_lipschitz, device=device)
    if anneal_pj and method == "mhlj":
        pj_sched = pj_schedules.polynomial_decay(p_j, steps, t0=max(1, steps // 4))
    else:
        pj_sched = np.full(steps, params_w.p_j, np.float32)
    if uniforms is not None:
        uniforms = torch.as_tensor(np.asarray(uniforms, np.float32),
                                   device=device)

    # deterministic resume: params, optimizer and walk state (its generator
    # included) AND the pipeline counter, so a restarted job continues the
    # SAME walk trajectory and batch stream
    start_step = 0
    if resume and checkpoint_dir and ckpt.latest_step(checkpoint_dir) is not None:
        walk_state["p_j"] = torch.zeros((), dtype=torch.float32, device=device)
        out = ckpt.load_checkpoint(checkpoint_dir, params, opt_state, walk_state)
        with torch.no_grad():
            for dst, src in zip(leaves(params), leaves(out["params"])):
                dst.copy_(src)
        opt_state, walk_state = out["opt_state"], out["walk_state"]
        start_step = out["step"]
        pipeline._counter = out["extra"].get("pipeline_counter",
                                             seed + start_step)

    step_fn = make_train_step(model, optimizer, walk, projections=projections,
                              on_phase=on_phase)

    def mark(name):
        if on_phase is not None:
            on_phase(name)

    losses, nodes = [], []
    t0 = time.time()
    for t in range(start_step, steps):
        mark("step")
        node = int(walk_state["node"])
        batch = {k: torch.as_tensor(v, device=device)
                 for k, v in pipeline.next_batch(node).items()}
        walk_state["p_j"] = torch.tensor(float(pj_sched[t]), dtype=torch.float32,
                                         device=device)
        mark("host")
        params, opt_state, walk_state, metrics = step_fn(
            params, opt_state, walk_state, batch,
            uniforms=None if uniforms is None else uniforms[t],
        )
        losses.append(float(metrics["loss"]))
        nodes.append(node)
        if log_every and (t % log_every == 0 or t == steps - 1):
            print(
                f"step {t:5d}  node {node:3d}  loss {losses[-1]:.4f}  "
                f"w {float(metrics['weight']):.3f}",
                flush=True,
            )
        if checkpoint_dir and checkpoint_every and (t + 1) % checkpoint_every == 0:
            ckpt.save_checkpoint(
                checkpoint_dir, t + 1, params, opt_state, walk_state,
                extra={
                    "arch": cfg.name,
                    "method": method,
                    "pipeline_counter": pipeline._counter,
                },
            )
    dt = time.time() - t0
    hops = int(walk_state["hops"])
    updates = int(walk_state["updates"])
    return {
        "losses": np.asarray(losses),
        "update_nodes": np.asarray(nodes),
        "transitions_per_update": hops / max(updates, 1),
        "steps_per_sec": steps / dt,
        "params": params,
        "opt_state": opt_state,
        "walk_state": walk_state,
        "final_lipschitz": walk_state["lipschitz"].cpu().numpy(),
    }


def _custom_cfg(args):
    base = get_arch(args.arch)
    return dataclasses.replace(
        reduced(base),
        name=f"{args.arch}-custom",
        num_layers=args.layers,
        d_model=args.d_model,
        num_heads=args.heads,
        num_kv_heads=min(args.heads, base.num_kv_heads) or args.heads,
        head_dim=args.d_model // args.heads,
        d_ff=args.d_ff or 4 * args.d_model,
        vocab_size=args.vocab,
        loss_chunks=1,
    )


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--arch", default="qwen2.5-32b", choices=sorted(ARCHITECTURES))
    ap.add_argument("--scale", default="smoke", choices=["smoke", "custom", "full"])
    ap.add_argument("--graph", default="ring", choices=sorted(GRAPHS))
    ap.add_argument("--silos", type=int, default=16)
    ap.add_argument("--method", default="mhlj", choices=["mhlj", "importance", "uniform"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--p-j", type=float, default=0.1)
    ap.add_argument("--anneal-pj", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --checkpoint-dir")
    # --scale custom model dims (a ~100M-class model)
    ap.add_argument("--layers", type=int, default=8)
    ap.add_argument("--d-model", type=int, default=512)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--d-ff", type=int, default=0)
    ap.add_argument("--vocab", type=int, default=8192)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.scale == "smoke":
        cfg = reduced(get_arch(args.arch))
    elif args.scale == "custom":
        cfg = _custom_cfg(args)
    else:
        cfg = get_arch(args.arch)

    print(f"arch={cfg.name} params~{cfg.param_count()/1e6:.1f}M "
          f"method={args.method} graph={args.graph}({args.silos})", flush=True)
    res = run_training(
        cfg,
        graph_kind=args.graph,
        n_silos=args.silos,
        method=args.method,
        steps=args.steps,
        batch_size=args.batch,
        seq_len=args.seq,
        lr=args.lr,
        p_j=args.p_j,
        anneal_pj=args.anneal_pj,
        seed=args.seed,
        checkpoint_dir=args.checkpoint_dir,
        checkpoint_every=args.checkpoint_every,
        resume=args.resume,
        device=args.device,
    )
    summary = {
        "loss_first10": float(res["losses"][:10].mean()),
        "loss_last10": float(res["losses"][-10:].mean()),
        "transitions_per_update": res["transitions_per_update"],
        "steps_per_sec": res["steps_per_sec"],
    }
    print(json.dumps(summary, indent=2))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
