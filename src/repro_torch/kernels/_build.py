"""Build the port's CUDA sources with ``nvcc`` at first use, load with ctypes.

Each ``.cu`` file under ``repro_torch/csrc/`` exposes a plain C interface
and compiles on its own into a shared library under ``build/`` at the
repository root (listed in ``.gitignore``); ``.cuh`` headers there are
shared between sources.  A library's file name carries a digest of its
source, the headers and the flags, so an edited source or header is
rebuilt and never shadowed by a stale build.  :func:`build` starts one
``nvcc`` per missing library, all at once, and waits for them together.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Iterable, Optional

__all__ = ["SOURCES", "NVCC_FLAGS", "BUILD_DIR", "build", "load"]

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"

# library name -> source file under csrc/
SOURCES = {
    "walk_transition_ragged": "walk_transition_ragged.cu",
    "walk_transition_sparse": "walk_transition_sparse.cu",
    "walk_transition_dense": "walk_transition_dense.cu",
    "flash_attention": "flash_attention.cu",
    "flash_attention_wgmma": "flash_attention_wgmma.cu",
    "ssd_scan": "ssd_scan.cu",
    "ssd_scan_mma": "ssd_scan_mma.cu",
    "rmsnorm": "rmsnorm.cu",
    # not a kernel of the port: the timing harness's stream hold
    # (chip_smoke.py, device_time_ms)
    "stream_hold": "stream_hold.cu",
}

# No fast math, and no fused multiply-add contraction: the kernels' float32
# products must round exactly as their plain PyTorch versions' do.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_LOADED: dict = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin "
            "and PATH); the CUDA kernels cannot be built"
        )
    return found


def _target(name: str) -> Path:
    src = (CSRC / SOURCES[name]).read_bytes()
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha256(
        src + headers + " ".join(NVCC_FLAGS).encode()
    ).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: Optional[Iterable[str]] = None) -> dict:
    """Compile every missing library of ``names`` (default: all) in parallel.

    Returns ``{name: compiler output}`` for the libraries compiled by this
    call (``-Xptxas -v`` reports registers and spills there).  Raises
    ``RuntimeError`` with the compiler's output if any build fails.
    """
    names = list(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        out = _target(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / SOURCES[name])]
        procs[name] = (
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True,
            ),
            tmp,
            out,
        )
    logs, failed = {}, []
    for name, (proc, tmp, out) in procs.items():
        log, _ = proc.communicate()
        logs[name] = log
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("CUDA build failed: " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library ``name``, built first if it is missing."""
    lib = _LOADED.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(str(_target(name)))
        _LOADED[name] = lib
    return lib
