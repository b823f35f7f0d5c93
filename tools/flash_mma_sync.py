"""The attention kernel of the ``mma_sync`` route (``csrc/flash_attention.cu``)
on the card: its float32 error rule, and its speed beside SDPA's.

Run on the GPU machine from the repository root:

    PYTHONPATH=src python tools/flash_mma_sync.py [--src DIR] [--repeat R]

``--src DIR`` imports ``repro_torch`` from another checkout's ``src`` (say
the parent commit unpacked under ``build/``), whose kernels then build
under that checkout, so two kernels can be compared on one card (run
them in turns: parent, change, change, parent).  Every case is causal,
B=1, S=T=4096, on N(0, 1) inputs from a seeded generator, and goes through
``ops.mha`` (the route ``route_of`` picks).  Prints:

- for each float32 case, the share of outputs beyond the float32 rule
  (2e-5 as atol and rtol) against the plain version, and the max abs error
  of the kernel and of the plain version against a float64 result;
- for every case: the route and its launches, the max abs error against
  the plain version, device ms per call (held CUDA events,
  ``chip_smoke.device_time_ms``, ``R`` runs), SDPA's ms on the same
  inputs, the bound (4h flops a live (row, col) pair at 989 TFLOP/s in 16
  bits, at a third of 495 TFLOP/s in float32 (split TF32), or the bytes at
  3.35 TB/s if larger), and TFLOP/s;
- ptxas' registers and spills of the ``flash_attention`` library, the card's
  name and power limit, and one JSON line of all of it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]

# (label, dtype name, (N, K, h), aligned)
CASES = (
    ("bf16 h=128 unaligned", "bfloat16", (32, 8, 128), False),
    ("float16 h=100", "float16", (16, 4, 100), True),
    ("bf16 h=100", "bfloat16", (16, 4, 100), True),
    ("bf16 h=320", "bfloat16", (8, 1, 320), True),
    ("float32 h=512", "float32", (8, 1, 512), True),
    ("float32 h=256", "float32", (8, 1, 256), True),
    ("float32 minitron layer h=128", "float32", (32, 8, 128), True),
    ("bf16 minitron layer h=128 (wgmma)", "bfloat16", (32, 8, 128), True),
)
PEAK_16 = 989e12        # dense bf16/fp16 on the tensor cores
PEAK_F32 = 495e12 / 3   # dense TF32, three products for each one
HBM = 3.35e12
F32_TOL = 2e-5


def attention_f64(q, k, v):
    """Causal softmax attention in float64, (B, S, N, h) in and out."""
    qd, kd, vd = (t.double().transpose(1, 2) for t in (q, k, v))
    rep = qd.shape[1] // kd.shape[1]
    kd, vd = (t.repeat_interleave(rep, dim=1) for t in (kd, vd))
    out = []
    for n in range(qd.shape[1]):  # one head at a time: (S, T) float64 each
        sc = (qd[:, n] @ kd[:, n].transpose(1, 2)) * qd.shape[-1] ** -0.5
        sc = sc.masked_fill(sc.new_ones(sc.shape[-2:], dtype=bool).triu(1),
                            float("-inf"))
        out.append(sc.softmax(-1) @ vd[:, n])
    return torch.stack(out, dim=2)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src directory to import repro_torch from")
    ap.add_argument("--repeat", type=int, default=3, help="timed runs a case")
    args = ap.parse_args()
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import repro_torch  # noqa: E402  (from --src, before chip_smoke's path)

    if not str(Path(repro_torch.__file__).resolve()).startswith(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.utils.kernel_bounds import flash_bound

    if not torch.cuda.is_available():
        print("flash_mma_sync: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    print(smi)
    logs = _build.build(["flash_attention", "flash_attention_wgmma",
                         "stream_hold"])
    for line in logs.get("flash_attention", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc flash_attention: {line.strip()}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    report = {"card": smi, "src": src, "cases": {}}
    for label, dname, (n, kh, h), aligned in CASES:
        dtype = getattr(torch, dname)
        gen.manual_seed(h + n)
        s = 4096
        q = chip_smoke.randn_at((1, s, n, h), dtype, gen, dev, aligned)
        k, v = (chip_smoke.randn_at((1, s, kh, h), dtype, gen, dev)
                for _ in range(2))
        before = dict(fa_ops.mha.launches_by_route)
        got = fa_ops.mha(q, k, v, causal=True)
        torch.cuda.synchronize()
        went = {r: fa_ops.mha.launches_by_route[r] - before[r] for r in before}
        plain = mha_ref(q, k, v, causal=True)
        r = {"route": [x for x, c in went.items() if c] or None,
             "launches": went,
             "max_abs_err_plain": float((got.float() - plain.float()).abs().max())}
        if dtype == torch.float32:
            d = (got - plain).abs()
            r["share_beyond_f32_rule"] = float(
                (d > F32_TOL + F32_TOL * plain.abs()).double().mean())
            exact = attention_f64(q, k, v)
            r["f64_err_kernel"] = float((got.double() - exact).abs().max())
            r["f64_err_plain"] = float((plain.double() - exact).abs().max())
            del exact
        del got, plain
        torch.cuda.empty_cache()
        ms = [chip_smoke.device_time_ms(
            lambda i: fa_ops.mha(q, k, v, causal=True), 10)[0]
            for _ in range(args.repeat)]
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        sdpa = chip_smoke.device_time_ms(
            lambda i: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=True, enable_gqa=True), 10)[0]
        nbytes, ops = flash_bound(1, s, s, n, kh, h, q.element_size(), True, 0)
        bound = max(nbytes / HBM, ops / (PEAK_F32 if dtype == torch.float32
                                         else PEAK_16)) * 1e3
        r.update({"ms": ms, "sdpa_ms": sdpa, "bound_ms": bound,
                  "tflops": ops / min(ms) / 1e9, "bound_share": bound / min(ms)})
        report["cases"][label] = r
        print(f"{label}: " + json.dumps(r))
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
