"""What every kernel wrapper of the port shares: device and input checks,
the current stream, the ctypes call of a library's launch function, and
the registry of launch counts.

Each CUDA source exposes one C function ``<name>_launch`` that returns
``cudaGetLastError()`` after its launch; :func:`launch` raises on any
non-zero code, so a refused launch never passes silently.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from repro_torch.kernels import _build

__all__ = ["P", "I", "F", "COUNTED", "counted", "launch", "query",
           "device_of", "check", "forward_only", "stream"]

# ctypes argument types: a pointer or the stream, an int, a float
P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

# The wrappers whose ``launches`` attribute counts their kernel's launches.
# A wrapper adds one where it launches; under a CUDA graph that is once per
# launch captured, and ``repro_torch.core.scan`` adds what each replay of
# the graph runs, so every count stays the number of launches the card ran.
COUNTED: list = []


def counted(fn):
    """Give the kernel wrapper ``fn`` a ``launches`` count of 0 and register
    it in :data:`COUNTED`."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


@functools.lru_cache(maxsize=None)
def _function(name: str, symbol: str, argtypes: tuple, restype):
    fn = getattr(_build.load(name), symbol)
    fn.argtypes = list(argtypes)
    fn.restype = restype
    return fn


def launch(name: str, argtypes, *args) -> None:
    """Call ``<name>_launch(*args)`` from library ``name``; raise on a CUDA
    error code."""
    err = _function(name, f"{name}_launch", tuple(argtypes), ctypes.c_int)(*args)
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


def query(name: str, symbol: str, argtypes, restype, *args):
    """The result of the host function ``symbol`` of library ``name``: what
    a wrapper asks the C side before a launch (a scratch size)."""
    return _function(name, symbol, tuple(argtypes), restype)(*args)


def device_of(*tensors) -> torch.device:
    """The one device of ``tensors``: CPU or CUDA, else raise."""
    devices = {t.device for t in tensors}
    if len(devices) != 1:
        raise ValueError(f"all inputs must be on one device, got {devices}")
    device = devices.pop()
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device


def check(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Raise unless ``t`` has one of ``dtypes``, ``ndim`` dimensions and a
    contiguous layout."""
    dtypes = dtypes if isinstance(dtypes, tuple) else (dtypes,)
    if t.dtype not in dtypes:
        raise TypeError(f"{name} must be one of {dtypes}, got {t.dtype}")
    if t.ndim != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def forward_only(name: str, *tensors) -> None:
    """Raise when gradients are recorded through a kernel: no CUDA kernel of
    the port has a backward (nor has the JAX package's Pallas kernel, whose
    ``jax.grad`` fails), so a differentiable input would silently lose its
    gradient.  Training runs the plain layers (``cfg.use_kernels=False``)."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name}: the CUDA kernel has no backward, and an input requires "
            "grad; train with cfg.use_kernels=False (the plain layers), or "
            "call it under torch.no_grad()"
        )


def stream(device: torch.device) -> int:
    """The current CUDA stream of ``device``, as the int ctypes passes."""
    return torch.cuda.current_stream(device).cuda_stream
