"""The SSD scan's float16 ``mma_bf16`` route past float16's range, and its
speed, on the card.

Run on the GPU machine from the repository root:

    PYTHONPATH=src python tools/ssd_float16_range.py [--src DIR]

``--src DIR`` imports ``repro_torch`` from another checkout's ``src`` (say
the parent commit unpacked under ``build/``), whose kernels then build
under that checkout, so two kernels can be compared on one card (run
them in turns: parent, change, change, parent).  Prints:

- for each of ``tests/test_torch_cuda.py``'s ``SSD_RANGE_CASES`` (float16
  inputs whose split operands pass 65504), in float16 and, on the same
  draws, in bf16: the routes' launches, the non-finite share of y, max |y|
  of the float64 chunked scan, and the max abs error of the finite
  outputs against it (all, the first chunk, the rest) beside the float32
  plain version's;
- device ms per call (held CUDA events, ``chip_smoke.device_time_ms``) of
  float16 at mamba2-370m's layer (B=1, H=32, L=4096, P=64, N=128, chunk
  256) and bf16 at B=4, on random inputs from a seeded generator (as
  ``chip_smoke.py``'s phase 6), with a digest of each output;
- a digest of each ``ssd_scan_mma`` kernel's SASS (``cuobjdump -sass``),
  by mangled name, so two checkouts' builds can be compared;
- the card's name and power limit, and one JSON line of all of it.
"""
from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def sass_digests(build) -> dict:
    """{mangled kernel name: digest of its SASS} of the built
    ``ssd_scan_mma`` library."""
    tool = Path(build._nvcc()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(build._target("ssd_scan_mma"))],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    out, name, body = {}, None, []
    for line in text.splitlines() + ["Function : "]:
        if "Function : " in line:
            if name:
                out[name] = hashlib.sha256("\n".join(body).encode()).hexdigest()[:16]
            name, body = line.split("Function : ", 1)[1].strip(), []
        elif name:
            body.append(line.strip())
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="the checkout's src directory to import repro_torch from")
    args = ap.parse_args()
    src = str(Path(args.src).resolve())
    sys.path.insert(0, src)
    import repro_torch  # noqa: E402  (from --src, before chip_smoke's path)

    if not str(Path(repro_torch.__file__).resolve()).startswith(src):
        raise RuntimeError(f"repro_torch came from {repro_torch.__file__}")
    import torch

    sys.path.insert(1, str(ROOT))
    import chip_smoke
    from repro_torch.kernels import _build
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_ref

    # the card test's inputs, from its file (a package named ``tests`` may
    # be installed and shadow the repository's)
    spec = importlib.util.spec_from_file_location(
        "test_torch_cuda", ROOT / "tests" / "test_torch_cuda.py")
    card_tests = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(card_tests)

    if not torch.cuda.is_available():
        print("ssd_float16_range: no CUDA device", file=sys.stderr)
        return 2

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    print(f"repro_torch from {os.path.dirname(repro_torch.__file__)}")
    print(smi)
    for line in _build.build(["ssd_scan_mma", "stream_hold"]).get(
            "ssd_scan_mma", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"  nvcc ssd_scan_mma: {line.strip()}")
    dev = torch.device("cuda")
    report = {"card": smi, "src": src, "range": {}, "ms": {}}
    def errors(y, exact, chunk) -> list:
        """max abs error of the finite outputs: all, the first chunk (no
        state term), the rest"""
        d = (y.double() - exact).abs().where(torch.isfinite(y), 0.0)
        return [float(d.max()), float(d[:, :, :chunk].max()),
                float(d[:, :, chunk:].max())]

    for case in sorted(card_tests.SSD_RANGE_CASES):
        (xs, da, dt, bs, cs), chunk = card_tests._ssd_range_head_major(case)
        r = {}
        for dtype in (torch.float16, torch.bfloat16):  # bf16: the same draws
            t = tuple(torch.from_numpy(a).to(dev) for a in (xs, da, dt, bs, cs))
            t = tuple(a.to(dtype) if a.ndim == 4 else a for a in t)
            before = dict(ssd_ops.ssd_scan.launches_by_route)
            y = ssd_ops.ssd_scan(*t, chunk=chunk)
            torch.cuda.synchronize()
            went = {k: ssd_ops.ssd_scan.launches_by_route[k] - before[k]
                    for k in before}
            exact = ssd_scan_ref(*(a.double() for a in t), chunk=chunk)
            r[str(dtype)] = {
                "launches": went,
                "nonfinite_share": float((~torch.isfinite(y)).double().mean()),
                "max_abs_y": float(exact.abs().max()),
                "max_abs_err_finite": errors(y, exact, chunk),
                "plain_max_abs_err": errors(ssd_scan_ref(*t, chunk=chunk),
                                            exact, chunk)}
            print(f"range {case} {dtype}: " + json.dumps(r[str(dtype)]))
        report["range"][case] = r
    gen = torch.Generator(device=dev)
    for label, dtype, b in (("float16 B=1", torch.float16, 1),
                            ("bf16 B=4", torch.bfloat16, 4)):
        gen.manual_seed(b)
        h, l, p, n, chunk = 32, 4096, 64, 128, 256
        xs = torch.randn((b, h, l, p), generator=gen, device=dev).to(dtype)
        dt = torch.nn.functional.softplus(
            torch.randn((b, h, l), generator=gen, device=dev))
        da = dt * -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))[:, None]
        bs, cs = (torch.randn((b, h, l, n), generator=gen, device=dev).to(dtype)
                  for _ in range(2))
        t = (xs, da, dt, bs, cs)
        y = ssd_ops.ssd_scan(*t, chunk=chunk)
        err = float((y - ssd_scan_ref(*t, chunk=chunk)).abs().max())
        runs = [chip_smoke.device_time_ms(
            lambda i: ssd_ops.ssd_scan(*t, chunk=chunk), 20)[0] for _ in range(3)]
        dig = hashlib.sha256(y.cpu().numpy().tobytes()).hexdigest()[:16]
        report["ms"][label] = {"ms": runs, "y_digest": dig, "max_abs_err_plain": err}
        print(f"{label} (H=32, L=4096, P=64, N=128, chunk 256): device ms "
              f"{', '.join(f'{m:.5f}' for m in runs)}; y digest {dig}; max abs "
              f"err vs plain {err:.3e}")
    report["sass"] = sass_digests(_build)
    for name, dig in sorted(report["sass"].items()):
        print(f"sass {name} {dig}")
    print(json.dumps(report))
    return 0


if __name__ == "__main__":
    sys.exit(main())
