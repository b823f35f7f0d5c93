"""End-to-end driver: decentralized LLM pre-training with MHLJ routing, on
the port.

A ~35M-parameter llama-family model (qwen2.5 config family, custom dims)
is trained over a 16-silo Watts-Strogatz network with heterogeneous
per-silo token shards.  The walk decides which silo's data produces every
batch; silo importance (L_v) is estimated ONLINE from gradient-norm
secants (the paper's L_v has no closed form for LLM losses).  Compares
MHLJ against MH-uniform routing.  Training runs on the card unless
``--device cpu``.

Run:
  PYTHONPATH=src python examples/torch/llm_decentralized.py
Faster sanity pass (a 2-layer model, 10 steps of 2 x 32 tokens):
  PYTHONPATH=src python examples/torch/llm_decentralized.py --small
A ~110M configuration (slower, same code path):
  PYTHONPATH=src python examples/torch/llm_decentralized.py --big
The same step planned on the production mesh without a card:
``python -m repro_torch.launch.dryrun --shape train_4k``.
"""
import argparse
import dataclasses

from repro_torch.configs import get_arch, reduced
from repro_torch.launch.train import run_training


def model_cfg(scale: str):
    base = reduced(get_arch("qwen2.5-32b"))
    dims = {
        "small": dict(num_layers=2, d_model=256, num_heads=4, d_ff=1024, vocab_size=2048),
        "default": dict(num_layers=8, d_model=512, num_heads=8, d_ff=2048, vocab_size=8192),
        "big": dict(num_layers=12, d_model=768, num_heads=12, d_ff=3072, vocab_size=16384),
    }[scale]
    return dataclasses.replace(
        base,
        name=f"qwen-family-{scale}",
        num_kv_heads=dims["num_heads"] // 2,
        head_dim=dims["d_model"] // dims["num_heads"],
        loss_chunks=1,
        **dims,
    )


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=None,
                    help="default 200 (10 with --small)")
    ap.add_argument("--small", action="store_true")
    ap.add_argument("--big", action="store_true")
    ap.add_argument("--batch", type=int, default=2)
    ap.add_argument("--seq", type=int, default=None,
                    help="default 256 (32 with --small)")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    steps = args.steps or (10 if args.small else 200)
    seq = args.seq or (32 if args.small else 256)

    cfg = model_cfg("big" if args.big else ("small" if args.small else "default"))
    print(f"model: {cfg.name}  ~{cfg.param_count() / 1e6:.1f}M params  "
          f"device={args.device}")

    results = {}
    for method in ("uniform", "mhlj"):
        print(f"\n=== routing method: {method} ===")
        results[method] = run_training(
            cfg,
            graph_kind="watts_strogatz",
            n_silos=16,
            method=method,
            steps=steps,
            batch_size=args.batch,
            seq_len=seq,
            lr=1e-3,
            online_lipschitz=method == "mhlj",
            log_every=max(1, steps // 10),
            seed=0,
            checkpoint_dir=args.checkpoint_dir,
            checkpoint_every=max(1, steps // 2) if args.checkpoint_dir else 0,
            device=args.device,
        )

    print("\n=== summary ===")
    for method, res in results.items():
        lo = res["losses"]
        print(
            f"{method:<8} loss {lo[:10].mean():.3f} -> {lo[-10:].mean():.3f}   "
            f"hops/update {res['transitions_per_update']:.3f}   "
            f"{res['steps_per_sec']:.2f} steps/s"
        )
    lips = results["mhlj"]["final_lipschitz"]
    print(f"online L_v estimates: min {lips.min():.3g}  mean {lips.mean():.3g}  "
          f"max {lips.max():.3g}  (hard silos get larger L_v -> more visits)")
    return results


if __name__ == "__main__":
    main()
