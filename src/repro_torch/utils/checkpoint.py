"""Checkpoints of the training state: pytrees <-> npz with key paths, in the
JAX package's layout, so either package's checkpoint loads in the port.

Atomic writes (temporary file + rename), numbered ``step_%010d/``
directories holding ``params.npz``, ``opt_state.npz`` and
``walk_state.npz``, a ``MANIFEST.json`` written last (its presence marks a
checkpoint complete), latest-``keep`` retention, and a manifest ``extra``
carrying what a restarted job needs to resume the SAME walk (Algorithm 1
is sequential: resuming from the wrong node silently changes the sampled
distribution).

Key paths are the reference's: dict keys and NamedTuple field names, tuple
indices, joined by ``/`` (``mu/layers/attn/wq``, ``inner/1/count``).
Inside a dict a tuple of tensors is a per-layer leaf
(``repro_torch.models.base``) and is stored as the reference's stacked
``(L, ...)`` array, a tuple of such tuples (the hybrid's stacks in
stacks) as its ``(P, n, ...)`` array.  bfloat16 tensors are stored as the reference stores
them (two-byte ``|V2`` records).  A ``torch.Generator`` (the walk's
``"rng"``) is stored as its ``get_state()`` bytes, a tuple of them (a
fleet's) as one ``(W, state)`` array; a reference checkpoint's ``rng`` is a
uint32 PRNG key, which loading keeps as data (a numpy array).
"""
from __future__ import annotations

import json
import os
import re
import shutil
import tempfile
from typing import Any, Optional

import numpy as np
import torch

__all__ = [
    "flatten_with_paths",
    "unflatten_from_paths",
    "save_pytree",
    "load_pytree",
    "save_checkpoint",
    "load_checkpoint",
    "latest_step",
]

_SEP = "/"


def _join(path: str, key) -> str:
    return f"{path}{_SEP}{key}" if path else str(key)


def _is_named(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(obj, "_fields")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.dtype("V2"))
    return t.numpy()


def _to_torch(arr: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    arr = np.asarray(arr)
    if tuple(arr.shape) != tuple(like.shape):
        raise ValueError(f"checkpoint array of shape {arr.shape}, expected "
                         f"{tuple(like.shape)}")
    arr = np.array(arr)  # a contiguous copy that keeps a 0-d shape
    if like.dtype == torch.bfloat16:
        t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr).to(like.dtype)
    return t.to(like.device)


def _stacked_leaf(value) -> bool:
    """A tuple of tensors or generators, or a tuple of such tuples (a stack
    in a stack, the hybrid's ``(P, n, ...)`` leaves)."""
    return (isinstance(value, tuple) and not _is_named(value) and len(value)
            > 0 and (all(isinstance(v, (torch.Tensor, torch.Generator))
                         for v in value)
                     or all(_stacked_leaf(v) for v in value)))


def _stack(value) -> np.ndarray:
    if isinstance(value, tuple):
        return np.stack([_stack(v) for v in value])
    if isinstance(value, torch.Generator):
        return value.get_state().numpy()
    return _to_numpy(value)


def _unstack(arr: np.ndarray, like, path: str):
    if isinstance(like, tuple):
        if arr.shape[0] != len(like):
            raise ValueError(f"{path}: {arr.shape[0]} stacked entries, "
                             f"expected {len(like)}")
        return tuple(_unstack(a, x, path) for a, x in zip(arr, like))
    if isinstance(like, torch.Generator):
        return _generator_like(arr, like)
    return _to_torch(arr, like)


def flatten_with_paths(tree: Any) -> dict:
    """``{path: np.ndarray}`` of every leaf of ``tree``."""
    flat: dict = {}

    def put(path, arr):
        if path in flat:
            raise ValueError(f"duplicate checkpoint key {path!r}")
        flat[path] = arr

    def visit(obj, path):
        if isinstance(obj, torch.Generator):
            put(path, obj.get_state().numpy())
        elif isinstance(obj, torch.Tensor):
            put(path, _to_numpy(obj))
        elif isinstance(obj, dict):
            for k, v in obj.items():
                if _stacked_leaf(v):
                    put(_join(path, k), _stack(v))
                else:
                    visit(v, _join(path, k))
        elif _is_named(obj):
            for k, v in zip(obj._fields, obj):
                visit(v, _join(path, k))
        elif isinstance(obj, (tuple, list)):
            for i, v in enumerate(obj):
                visit(v, _join(path, i))
        elif obj is None:
            return
        else:
            put(path, np.asarray(obj))

    visit(tree, "")
    return flat


def _generator_like(state: np.ndarray, like: torch.Generator):
    """A generator in ``state`` (``get_state()`` bytes) on ``like``'s device;
    a reference PRNG key (not bytes) stays a numpy array."""
    if state.dtype != np.uint8:
        return np.array(state)
    gen = torch.Generator(device=like.device)
    gen.set_state(torch.from_numpy(np.array(state)))
    return gen


def unflatten_from_paths(like: Any, flat: dict) -> Any:
    """``like``'s structure holding the arrays of ``flat``: tensors on the
    device and in the dtype of ``like``'s, generators set to the stored
    states."""

    def get(path):
        if path not in flat:
            raise KeyError(f"checkpoint missing key {path!r}")
        return flat[path]

    def build(obj, path):
        if isinstance(obj, torch.Generator):
            return _generator_like(get(path), obj)
        if isinstance(obj, torch.Tensor):
            return _to_torch(get(path), obj)
        if isinstance(obj, dict):
            out = {}
            for k, v in obj.items():
                p = _join(path, k)
                if _stacked_leaf(v):
                    out[k] = _unstack(get(p), v, p)
                else:
                    out[k] = build(v, p)
            return out
        if _is_named(obj):
            return type(obj)(*(build(v, _join(path, k))
                               for k, v in zip(obj._fields, obj)))
        if isinstance(obj, (tuple, list)):
            return type(obj)(build(v, _join(path, i)) for i, v in enumerate(obj))
        if obj is None:
            return None
        return np.array(get(path))

    return build(like, "")


def save_pytree(path: str, tree: Any) -> None:
    """Atomic npz write of one pytree."""
    flat = flatten_with_paths(tree)
    directory = os.path.dirname(os.path.abspath(path))
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    os.close(fd)
    try:
        np.savez(tmp, **flat)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load_pytree(path: str, like: Any) -> Any:
    """Load an npz checkpoint into the structure of ``like``."""
    with np.load(path) as z:
        flat = {k: z[k] for k in z.files}
    return unflatten_from_paths(like, flat)


_STEP_RE = re.compile(r"^step_(\d{10})$")


def _step_dir(root: str, step: int) -> str:
    return os.path.join(root, f"step_{step:010d}")


def latest_step(root: str) -> Optional[int]:
    if not os.path.isdir(root):
        return None
    steps = [
        int(m.group(1))
        for d in os.listdir(root)
        if (m := _STEP_RE.match(d))
        and os.path.exists(os.path.join(root, d, "MANIFEST.json"))
    ]
    return max(steps) if steps else None


def save_checkpoint(
    root: str,
    step: int,
    params: Any,
    opt_state: Any = None,
    walk_state: Any = None,
    extra: Optional[dict] = None,
    keep: int = 3,
) -> str:
    """Write one numbered checkpoint; prune to the newest ``keep``."""
    final = _step_dir(root, step)
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp, exist_ok=True)
    save_pytree(os.path.join(tmp, "params.npz"), params)
    manifest = {"step": step, "extra": extra or {}}
    if opt_state is not None:
        save_pytree(os.path.join(tmp, "opt_state.npz"), opt_state)
        manifest["has_opt_state"] = True
    if walk_state is not None:
        save_pytree(os.path.join(tmp, "walk_state.npz"), walk_state)
        manifest["has_walk_state"] = True
    # manifest written LAST: its presence marks the checkpoint complete
    with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.replace(tmp, final)

    if keep > 0:
        steps = sorted(
            int(m.group(1)) for d in os.listdir(root) if (m := _STEP_RE.match(d))
        )
        for old in steps[:-keep]:
            shutil.rmtree(_step_dir(root, old), ignore_errors=True)
    return final


def load_checkpoint(
    root: str,
    like_params: Any,
    like_opt_state: Any = None,
    like_walk_state: Any = None,
    step: Optional[int] = None,
) -> dict:
    """Restore the given (or latest) step into the structures (and devices,
    dtypes) of the ``like_*`` trees; returns a dict with the restored
    trees, ``step`` and the manifest's ``extra``."""
    if step is None:
        step = latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {root!r}")
    d = _step_dir(root, step)
    with open(os.path.join(d, "MANIFEST.json")) as f:
        manifest = json.load(f)
    out = {
        "step": step,
        "extra": manifest.get("extra", {}),
        "params": load_pytree(os.path.join(d, "params.npz"), like_params),
    }
    if like_opt_state is not None and manifest.get("has_opt_state"):
        out["opt_state"] = load_pytree(os.path.join(d, "opt_state.npz"),
                                       like_opt_state)
    if like_walk_state is not None and manifest.get("has_walk_state"):
        out["walk_state"] = load_pytree(os.path.join(d, "walk_state.npz"),
                                        like_walk_state)
    return out
