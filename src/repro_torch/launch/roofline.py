"""Roofline analysis: three time terms per (arch x shape) from a capture
(``repro_torch.launch.roofline_capture``), on one H100's figures
(``repro_torch.launch.mesh.HW``):

  compute term    = FLOPs / dense bf16 peak             (per device: the
  memory term     = bytes / HBM bandwidth                capture counts one
  collective term = ring-cost bytes / link bandwidth     device's program)

The link of a collective is NVLink when its group fits in one node of
``HW.NODE_GPUS`` GPUs and the node's network port beyond
(``HW.link_bw``).  Also ``MODEL_FLOPS = 6 * N(_active) * D`` (training;
2 for prefill and decode) per device and the usefulness ratio
``MODEL_FLOPS / FLOPs`` (recompute and redundancy waste).  Ring costs are
``repro_torch.utils.collectives``': all-reduce ~ 2x its bytes,
all-gather / reduce-scatter / all-to-all (g-1)/g, others 1x.

The JAX package's ``benchmarks/roofline.py``, as a package module.
"""
from __future__ import annotations

import json
import os

from repro_torch.configs import SHAPES_BY_NAME, get_arch
from repro_torch.launch.mesh import HW

__all__ = ["model_flops_per_device", "analyze_record", "load_capture",
           "format_table"]


def model_flops_per_device(rec: dict) -> float:
    """6*N_active*D analytic model FLOPs for this case, per device."""
    shape = SHAPES_BY_NAME[rec["shape"]]
    cfg = get_arch(rec["arch"])
    n_active = rec.get("params_active") or cfg.active_param_count()
    chips = 512 if rec["multi_pod"] else 256
    if rec["kind"] == "train":
        tokens = shape.global_batch * shape.seq_len
        mult = 6  # fwd + bwd
    elif rec["kind"] == "prefill":
        tokens = shape.global_batch * shape.seq_len
        mult = 2
    else:  # decode: one token per sequence
        tokens = shape.global_batch
        mult = 2
    return mult * n_active * tokens / chips


def _collective_seconds(coll: dict) -> float:
    by_group = coll.get("by_group")
    if by_group:
        return sum(ring / HW.link_bw(int(g)) for g, ring in by_group.items())
    # a record without group sizes: the production mesh's 16-device axes,
    # which span nodes
    ring = coll.get("total_ring_cost_bytes", coll["total_bytes"])
    return ring / HW.link_bw(16)


def analyze_record(rec: dict) -> dict:
    coll = rec["collectives"]
    flops = rec["flops"]
    t_comp = flops / HW.PEAK_FLOPS_BF16
    t_mem = rec["bytes_accessed"] / HW.HBM_BW
    t_coll = _collective_seconds(coll)
    terms = {"compute": t_comp, "memory": t_mem, "collective": t_coll}
    dominant = max(terms, key=terms.get)
    mf = model_flops_per_device(rec)
    return {
        "arch": rec["arch"],
        "shape": rec["shape"],
        "mesh": "2x16x16" if rec["multi_pod"] else "16x16",
        "kind": rec["kind"],
        "compute_s": t_comp,
        "memory_s": t_mem,
        "collective_s": t_coll,
        "dominant": dominant,
        "bound_s": terms[dominant],
        "model_flops_per_dev": mf,
        "useful_ratio": mf / flops if flops > 0 else float("nan"),
        "hbm_gb": rec["memory"].get("temp_size_in_bytes", 0) / 1e9,
    }


def load_capture(path: str) -> list:
    """The analysed ``ok`` records of a capture file (the last record of
    each (arch, shape, mesh) wins; ``fail`` records are skipped)."""
    recs = {}
    if not os.path.exists(path):
        return []
    with open(path) as f:
        for line in f:
            r = json.loads(line)
            if r.get("status") == "ok":
                recs[(r["arch"], r["shape"], r["multi_pod"])] = r
    return [analyze_record(r) for r in recs.values()]


def format_table(rows: list) -> str:
    hdr = (f"{'arch':<22}{'shape':<13}{'mesh':<9}{'compute_s':>11}{'memory_s':>11}"
           f"{'collect_s':>11}{'dominant':>11}{'useful':>8}")
    lines = [hdr, "-" * len(hdr)]
    for r in sorted(rows, key=lambda r: (r["arch"], r["shape"])):
        lines.append(
            f"{r['arch']:<22}{r['shape']:<13}{r['mesh']:<9}"
            f"{r['compute_s']:>11.4g}{r['memory_s']:>11.4g}{r['collective_s']:>11.4g}"
            f"{r['dominant']:>11}{r['useful_ratio']:>8.2f}"
        )
    return "\n".join(lines)


if __name__ == "__main__":
    import sys

    rows = load_capture(sys.argv[1] if len(sys.argv) > 1 else "roofline.jsonl")
    print(format_table(rows) if rows else "no ok records; run "
          "`python -m repro_torch.launch.roofline_capture --out roofline.jsonl`")
