"""Roofline capture: the three cost terms' sources per (arch x shape), one
JSONL record each (the JAX package's ``launch/roofline_capture.py``).

Each case is planned by :func:`repro_torch.launch.dryrun.lower_case` on
the production mesh: the step runs once on fake tensors over a fake
process group, and ``repro_torch.utils.op_cost`` counts its per-device
FLOPs and bytes as it runs, every layer included (eager Python has no
loop body priced once, so there is nothing to re-price).  The record
keeps the reference's keys; ``xla_cost_analysis`` holds the same counts
(the port has no second, body-once count).

Writes one JSONL record per case; read by ``repro_torch.launch.roofline``.

Run:  PYTHONPATH=src python -m repro_torch.launch.roofline_capture \\
          --out roofline.jsonl [--opt] [--multi-pod]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback

from repro_torch.configs import ARCHITECTURES, INPUT_SHAPES, get_arch, get_shape
from repro_torch.launch.dryrun import lower_case

__all__ = ["capture_case", "main"]


# The optimized configuration: Megatron-style kv-head repeat and the
# activation and dispatch layout constraints; a head-divisible 32x8 mesh
# for qwen2.5 (40 heads % 16 != 0).  Train and prefill only: the cached
# decode path keeps the baseline layout.
def _opt_settings(arch_name: str, shape_name: str) -> dict:
    kind = get_shape(shape_name).kind
    if kind == "decode":
        return {}
    mp = 16
    if arch_name == "qwen2.5-32b":
        mp = 8  # 40 heads % 16 != 0
    elif arch_name == "paligemma-3b":
        mp = 8  # 8 heads fit exactly
    elif arch_name == "whisper-tiny" and kind == "train":
        mp = 1  # 37M params: pure data parallel; prefill's batch 32 cannot
        # shard over data=256, so prefill keeps the 16x16 layout
    return {"extra": {"gqa_repeat_kv": True}, "model_parallel": mp}


def capture_case(
    arch_name: str, shape_name: str, multi_pod: bool = False, opt: bool = False
) -> dict:
    cfg = get_arch(arch_name)
    kw = _opt_settings(arch_name, shape_name) if opt else {}
    _, cost, info = lower_case(arch_name, shape_name, multi_pod, **kw)
    return {
        "arch": arch_name,
        "shape": shape_name,
        "multi_pod": multi_pod,
        "optimized": opt,
        "kind": info["kind"],
        "profile": info["profile"],
        "params_total": cfg.param_count(),
        "params_active": cfg.active_param_count(),
        "flops": cost.flops,
        "bytes_accessed": cost.bytes,
        "collectives": {
            "total_bytes": cost.coll_bytes,
            "total_ring_cost_bytes": cost.coll_ring_bytes,
            "by_kind": cost.coll_counts,
            "by_group": info["collectives"]["by_group"],
        },
        "xla_cost_analysis": {  # the reference's body-once numbers' slot
            "flops": info["flops"],
            "bytes_accessed": info["bytes_accessed"],
        },
        "memory": info["memory"],
        "compile_seconds": info["compile_seconds"],
        "status": "ok",
    }


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="capture the optimized configuration")
    ap.add_argument("--out", default="roofline.jsonl")
    args = ap.parse_args(argv)

    archs = list(ARCHITECTURES) if args.arch == "all" else args.arch.split(",")
    shapes = (
        [s.name for s in INPUT_SHAPES] if args.shape == "all" else args.shape.split(",")
    )
    n_ok = n_tot = 0
    for arch in archs:
        for shape in shapes:
            n_tot += 1
            tag = f"{arch} x {shape}"
            t0 = time.time()
            try:
                rec = capture_case(arch, shape, args.multi_pod, opt=args.opt)
                n_ok += 1
                print(
                    f"[OK]   {tag}: flops={rec['flops']:.3e} "
                    f"bytes={rec['bytes_accessed']:.3e} "
                    f"coll={rec['collectives']['total_bytes']:.3e}B "
                    f"({time.time() - t0:.0f}s)",
                    flush=True,
                )
            except Exception as e:
                rec = {
                    "arch": arch, "shape": shape, "multi_pod": args.multi_pod,
                    "status": "fail", "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-1500:],
                }
                print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
    print(f"\n{n_ok}/{n_tot} roofline captures complete", flush=True)
    return 0 if n_ok == n_tot else 1


if __name__ == "__main__":
    raise SystemExit(main())
