"""System benchmark: walk-orchestrated LLM training and serving throughput,
the port of the reference's ``benchmarks/llm_walk_throughput.py``.

Measures steps/s of the walk train step (reduced qwen config) per routing
method, decode tokens/s of the serving engine, and the raw sampler
throughput of the walk engine (transitions/s of a W-walk fleet) on the
port's two backends: ``plain`` (the plain PyTorch step, on the CPU) and
``cuda`` (the hand-written ``walk_transition_sparse`` kernel on the card),
in place of the reference's ``scan`` and ``pallas``.  The reference's
settings, seeds and ``derived`` keys; the values are wall-clock.
"""
from __future__ import annotations

import time

import numpy as np
import torch

from repro_torch.configs import get_arch, reduced
from repro_torch.core.engine import WalkEngine
from repro_torch.core.graphs import watts_strogatz
from repro_torch.core.transition import MHLJParams
from repro_torch.launch.serve import Request, ServeEngine
from repro_torch.launch.train import run_training

NAME = "llm_walk_throughput"
PAPER_CLAIM = (
    "System: walk-orchestrated training sustains the same step rate as "
    "static routing (the transition adds O(1) device work, Remark 1 bounds "
    "the extra hops); serving sustains continuous batching."
)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _sampler_throughput(device, walks: int, steps: int, iters: int) -> dict:
    """Transitions/s of one batched engine fleet on an orchestration graph."""
    device = torch.device(device)
    n = 512
    g = watts_strogatz(n, 8, 0.1, seed=0)
    rng = np.random.default_rng(0)
    lips = np.exp(rng.normal(size=n)).astype(np.float32)
    eng = WalkEngine.from_graph(g, MHLJParams(0.2, 0.5, 3), lipschitz=lips,
                                device=device)
    v0s = torch.arange(walks, dtype=torch.int32, device=device) % n

    def run_once(seed):
        gen = torch.Generator(device=device).manual_seed(seed)
        return eng.run(v0s, steps, generator=gen)

    nodes, hops = run_once(0)  # warm-up: the kernel's library, the capture
    _sync(device)
    t0 = time.time()
    for i in range(iters):
        nodes, hops = run_once(i + 1)
    _sync(device)
    dt = time.time() - t0
    return {
        "walks": walks,
        "steps": steps,
        "transitions_per_sec": walks * steps * iters / dt,
        "mean_hops_per_update": float(hops.double().mean()),
    }


def run(quick: bool = False, *, device="cuda") -> dict:
    device = torch.device(device)
    cfg = reduced(get_arch("qwen2.5-32b"))
    steps = 20 if quick else 60
    out = {"claim": PAPER_CLAIM, "train": {}}
    for method in ("uniform", "mhlj"):
        res = run_training(
            cfg, graph_kind="ring", n_silos=8, method=method, steps=steps,
            batch_size=2, seq_len=64, log_every=0, seed=0, device=device,
        )
        out["train"][method] = {
            "steps_per_sec": res["steps_per_sec"],
            "loss_drop": float(res["losses"][:5].mean() - res["losses"][-5:].mean()),
            "hops_per_update": res["transitions_per_update"],
        }

    # raw walk-engine sampler throughput (the orchestration hot path): the
    # plain step on the CPU, small; the CUDA kernel at fleet scale on the card
    out["sampler"] = {
        "plain": _sampler_throughput(
            "cpu", walks=256, steps=2 if quick else 8, iters=1 if quick else 2),
    }
    if device.type == "cuda":
        out["sampler"]["cuda"] = _sampler_throughput(
            device, walks=1024 if quick else 4096, steps=8,
            iters=2 if quick else 5)

    engine = ServeEngine(cfg, batch_size=4, cache_len=128, device=device)
    rng = np.random.default_rng(0)
    for rid in range(8):
        engine.submit(Request(rid, rng.integers(0, cfg.vocab_size, 8).astype(np.int32), 8))
    t0 = time.time()
    stats = engine.run()
    out["serve"] = {**{k: v for k, v in stats.items()}, "wall_s": time.time() - t0}
    sampler = out["sampler"].get("cuda", out["sampler"]["plain"])
    out["derived"] = {
        "mhlj_vs_uniform_step_rate": out["train"]["mhlj"]["steps_per_sec"]
        / out["train"]["uniform"]["steps_per_sec"],
        "serve_tokens_per_sec": stats["tokens_per_sec"],
        "slot_utilization": stats["slot_utilization"],
        "sampler_transitions_per_sec": sampler["transitions_per_sec"],
    }
    return out
