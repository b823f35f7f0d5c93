"""The SSD scan's ``mma_tf32`` route (``csrc/ssd_scan.cu``) on the card: its
float64 error rule, and its time beside its bound at every shape the route
takes on the port's paths.

Run on the GPU machine from the repository root:

    PYTHONPATH=src python tools/ssd_scan_tf32.py [--src DIR] [--repeat R]
        [--only TEXT]

``--src DIR`` imports ``repro_torch`` from another checkout's ``src`` (say
the parent commit unpacked under ``build/``), whose kernels then build
under that checkout, so two kernels can be compared on one card (run them
in turns: parent, change, change, parent).  Each case goes through
``ops.ssd_scan`` (the route ``route_of`` picks, whatever its name in that
checkout) on head-major inputs from a seeded generator: x, B, C N(0, 1) in
the case's dtype, dt = softplus(N(0, 1)), da = dt a with a = -exp(0.3
N(0, 1)) a head.  The cases: mamba2-370m's layer (B=4, L=4096, H=32,
P=64, N=128, chunk 256) in float32 and in bf16 (the ``mma_bf16`` route,
a control), and chip_smoke.py's phase-6 widths on the route.  Prints, for
every case: the route and its launches, the max abs error against the
plain version and, at N * chunk > 64 * 64, the kernel's and the plain
version's max abs error against a float64 result (the rule: at most
twice); device ms per call (held CUDA events, ``chip_smoke.device_time_ms``,
``R`` runs of 10 calls), the plain version's ms, each kernel's device ms
per launch under the profiler (CUPTI, 5 calls), the bound (operations at
989 TFLOP/s in 16 bits, at a third of 495 TFLOP/s in float32, or the
bytes at 3.35 TB/s if larger; ``kernel_bounds.ssd_bound``'s count) and
its share; then ptxas' registers and spills of the ``ssd_scan`` library,
the card's name and power limit, and one JSON line of all of it.
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

# (label, dtype name, (B, H, L, P, N, chunk), aligned)
CASES = (
    ("float32 mamba2 layer P=64 N=128", "float32", (4, 32, 4096, 64, 128, 256),
     True),
    ("float32 P=128 N=256", "float32", (1, 16, 4096, 128, 256, 256), True),
    ("float32 P=80 N=200", "float32", (1, 16, 4096, 80, 200, 256), True),
    ("float32 P=192 N=128", "float32", (1, 16, 4096, 192, 128, 256), True),
    ("float32 P=64 N=512", "float32", (1, 16, 4096, 64, 512, 256), True),
    ("bf16 P=64 N=128 unaligned", "bfloat16", (1, 32, 4096, 64, 128, 256),
     False),
    ("float16 P=32 N=24", "float16", (1, 16, 4096, 32, 24, 32), True),
    ("bf16 P=32 N=24", "bfloat16", (1, 16, 4096, 32, 24, 32), True),
    ("bf16 mamba2 layer P=64 N=128 (mma_bf16)", "bfloat16",
     (4, 32, 4096, 64, 128, 256), True),
)
# the SSD libraries' kernels, by the names the profiler's events carry
KERNELS = ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
           "ssd_chunk_out_kernel", "ssd_scan_kernel", "ssd_scan_pieced_kernel")
PEAK_16 = 989e12        # dense bf16/fp16 on the tensor cores
PEAK_F32 = 495e12 / 3   # dense TF32, three products for each one
HBM = 3.35e12


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src directory to import repro_torch from")
    ap.add_argument("--repeat", type=int, default=3, help="timed runs a case")
    ap.add_argument("--only", default="",
                    help="run only the cases whose label holds this text")
    args = ap.parse_args()
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import repro_torch  # noqa: E402  (from --src, before chip_smoke's path)

    if not str(Path(repro_torch.__file__).resolve()).startswith(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.utils.kernel_bounds import ssd_bound

    if not torch.cuda.is_available():
        print("ssd_scan_tf32: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    print(smi)
    logs = _build.build(["ssd_scan", "ssd_scan_mma", "stream_hold"])
    ptxas = [line.strip() for line in logs.get("ssd_scan", "").splitlines()
             if "registers" in line or "spill" in line]
    for line in ptxas:
        print(f"  nvcc ssd_scan: {line}")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    report = {"card": smi, "src": src, "ptxas": ptxas, "cases": {}}
    for label, dname, (b, h, l, p, n, chunk), aligned in CASES:
        if args.only not in label:
            continue
        dtype = getattr(torch, dname)
        gen.manual_seed(l + n + p + chunk)
        xs = chip_smoke.randn_at((b, h, l, p), dtype, gen, dev, aligned)
        dt = torch.nn.functional.softplus(
            torch.randn((b, h, l), generator=gen, device=dev))
        da = dt * -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))[:, None]
        bs, cs = (chip_smoke.randn_at((b, h, l, n), dtype, gen, dev)
                  for _ in range(2))
        ssd_args = (xs, da, dt, bs, cs)
        before = dict(ssd_ops.ssd_scan.launches_by_route)
        got = ssd_ops.ssd_scan(*ssd_args, chunk=chunk)
        torch.cuda.synchronize()
        went = {r: ssd_ops.ssd_scan.launches_by_route[r] - before[r]
                for r in before}
        plain = ssd_scan_ref(*ssd_args, chunk=chunk)
        r = {"shape": [b, h, l, p, n, chunk], "aligned": aligned,
             "route": [x for x, c in went.items() if c] or None,
             "launches": went,
             "max_abs_err_plain": float((got - plain).abs().max())}
        if n * chunk > 64 * 64:
            exact = ssd_scan_ref(*(t.double() for t in ssd_args), chunk=chunk)
            r["f64_err_kernel"] = float((got.double() - exact).abs().max())
            r["f64_err_plain"] = float((plain.double() - exact).abs().max())
            r["f64_ratio"] = r["f64_err_kernel"] / r["f64_err_plain"]
            del exact
        del got, plain
        torch.cuda.empty_cache()
        ms = [chip_smoke.device_time_ms(
            lambda i: ssd_ops.ssd_scan(*ssd_args, chunk=chunk), 10)[0]
            for _ in range(args.repeat)]
        plain_ms = chip_smoke.device_time_ms(
            lambda i: ssd_scan_ref(*ssd_args, chunk=chunk), 3)[0]
        prof = chip_smoke.profile_window(
            lambda: [ssd_ops.ssd_scan(*ssd_args, chunk=chunk) for _ in range(5)],
            "ssd_")
        passes = {}
        for kernel in KERNELS:
            names = [k for k in prof["device_ms_by_name"] if kernel in k]
            if names:
                passes[kernel] = (
                    sum(prof["device_ms_by_name"][k] for k in names)
                    / sum(prof["device_launches_by_name"][k] for k in names))
        nbytes, ops = ssd_bound(b, h, l, p, n, chunk, xs.element_size(), h)
        bytes_ms = nbytes / HBM * 1e3
        ops_ms = ops / (PEAK_F32 if dtype == torch.float32 else PEAK_16) * 1e3
        bound = max(bytes_ms, ops_ms)
        r.update({"ms": ms, "plain_ms": plain_ms, "passes_ms": passes,
                  "bound_ms": bound,
                  "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
                  "bound_share": bound / min(ms)})
        report["cases"][label] = r
        print(f"{label}: " + json.dumps(r))
        del ssd_args, xs, da, dt, bs, cs
        torch.cuda.empty_cache()
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
