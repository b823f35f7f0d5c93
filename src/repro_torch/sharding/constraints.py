"""The model tensors' layout constraints on a mesh, and the layers' local
calls, as DTensor redistributions that do nothing off a mesh.

The JAX package pins a few activations with ``with_sharding_constraint``
(``_maybe_constrain``: q, k, v and the attention output of the
repeated-kv path, the Mamba-2 mixer's x, B, C and dt, the MoE expert
buffers), a no-op when no mesh is active.  Here a tensor is on a mesh
when it is a ``torch.distributed.tensor.DTensor``: :func:`constrain`
redistributes it to the spec's placements; a plain tensor comes back as
it is, so results off a mesh keep their bits.

:func:`local_call` runs a function whose work splits over some dims (the
batch, the heads, the channels of a depthwise conv) on each device's
shard: the arguments are redistributed so that only those dims stay
sharded, the function runs on the local tensors, and its outputs are
wrapped back as DTensors of the placements given.
"""
from __future__ import annotations

import contextlib

__all__ = ["is_dtensor", "constrain", "local_call", "placements_of",
           "aligned_to", "sharded_einsum", "sharded_einsums", "pick_last",
           "whole_dim", "shard_offset", "lookup_rows"]


def is_dtensor(x) -> bool:
    """``x`` is a ``DTensor`` (without importing ``torch.distributed`` for
    a plain tensor)."""
    return hasattr(x, "placements") and hasattr(x, "device_mesh")


def constrain(x, spec: tuple):
    """The reference's ``_maybe_constrain``: ``x`` redistributed to ``spec``
    (one mesh axis name or ``None`` per dim) on its own mesh, each axis
    kept where the padding of an uneven split, ``ceil(dim/axis)*axis/dim``,
    is at most 2x and dropped otherwise; an axis the mesh lacks is
    dropped.  A plain tensor is returned unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    mesh = x.device_mesh
    names = tuple(mesh.mesh_dim_names or ())
    sizes = dict(zip(names, tuple(mesh.shape)))
    placements = [Replicate()] * len(names)
    for dim, axis in enumerate(spec):
        if axis is None or axis not in sizes or dim >= x.ndim:
            continue
        size, ax = x.shape[dim], sizes[axis]
        if -(-size // ax) * ax <= 2 * size:
            placements[names.index(axis)] = Shard(dim)
    if tuple(placements) == tuple(x.placements):
        return x
    return x.redistribute(mesh, placements)


def placements_of(x, keep: tuple) -> tuple:
    """``x``'s placements with every ``Shard`` of a dim outside ``keep``
    replaced by ``Replicate`` (a partial sum is reduced as well)."""
    from torch.distributed.tensor import Replicate, Shard

    keep = tuple(d % x.ndim for d in keep)
    return tuple(p if isinstance(p, Shard) and p.dim in keep else Replicate()
                 for p in x.placements)


def aligned_to(placements: tuple, dim_map: dict) -> tuple:
    """Placements for another tensor that follow ``placements``: a mesh
    dim sharding dim ``d`` shards the other tensor's dim ``dim_map[d]``
    (a dim absent from ``dim_map``: replicated)."""
    from torch.distributed.tensor import Replicate, Shard

    return tuple(Shard(dim_map[p.dim]) if isinstance(p, Shard)
                 and p.dim in dim_map else Replicate() for p in placements)


def local_call(fn, args: tuple, placements: tuple, out_placements, out_shapes):
    """``fn(*args)`` on each device's shard.

    ``placements[i]`` are the placements ``args[i]`` is redistributed to
    first (``None`` for an argument passed as it is); ``out_placements``
    and ``out_shapes`` are each output's placements and global shape (one
    of each, or tuples of them when ``fn`` returns a tuple).  Without a
    DTensor among ``args`` this is ``fn(*args)``.
    """
    if not any(is_dtensor(a) for a in args):
        return fn(*args)
    from torch.distributed.tensor import DTensor

    mesh = next(a.device_mesh for a in args if is_dtensor(a))
    local = []
    for a, want in zip(args, placements):
        if is_dtensor(a) and want is not None:
            if tuple(want) != tuple(a.placements):
                a = a.redistribute(mesh, want)
            a = a.to_local()
        local.append(a)
    out = fn(*local)

    def wrap(o, p, shape):
        stride = [1] * len(shape)
        for d in range(len(shape) - 2, -1, -1):
            stride[d] = stride[d + 1] * shape[d + 1]
        return DTensor.from_local(o.contiguous(), mesh, p, run_check=False,
                                  shape=tuple(shape), stride=tuple(stride))

    if isinstance(out, tuple):
        return tuple(o if o is None else wrap(o, p, sh)
                     for o, p, sh in zip(out, out_placements, out_shapes))
    return wrap(out, out_placements, out_shapes)


def sharded_einsum(equation: str, a, b):
    """``torch.einsum(equation, a, b)`` on DTensors, each device
    contracting its own shards.

    Per mesh dim one einsum label is split: the one both operands split,
    else the one an operand splits that the output keeps (the other
    operand's split is gathered first: an FSDP weight gathers its embed
    dim), else the one an operand splits.  An operand without that label
    is replicated on the dim; the output splits the label where it keeps
    it and holds partial sums where it is contracted away.  A plain
    tensor among the operands is replicated.
    """
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    ins, out = equation.replace(" ", "").split("->")
    la, lb = ins.split(",")
    mesh = (a if is_dtensor(a) else b).device_mesh
    rep = [Replicate()] * mesh.ndim
    a, b = (t if is_dtensor(t) else DTensor.from_local(
        t, mesh, rep, run_check=False) for t in (a, b))

    def label(p, labels):
        return labels[p.dim] if type(p) is Shard else None

    pa, pb, po = [], [], []
    for m in range(mesh.ndim):
        ca, cb = label(a.placements[m], la), label(b.placements[m], lb)
        if ca and cb and ca != cb:
            keep = ca if ca in out else (cb if cb in out else ca)
        else:
            keep = ca or cb
        if keep is None:
            pa.append(Replicate()), pb.append(Replicate()), po.append(Replicate())
            continue
        pa.append(Shard(la.index(keep)) if keep in la else Replicate())
        pb.append(Shard(lb.index(keep)) if keep in lb else Replicate())
        po.append(Shard(out.index(keep)) if keep in out else Partial())
    sizes = dict(zip(la, a.shape))
    sizes.update(zip(lb, b.shape))
    return local_call(lambda x, y: _torch_einsum(equation, x, y), (a, b),
                      (tuple(pa), tuple(pb)), tuple(po),
                      tuple(sizes[c] for c in out))


_EINSUM = []  # torch.einsum as it was before sharded_einsums patched it


def _torch_einsum(equation, *operands):
    import torch

    return (_EINSUM[0] if _EINSUM else torch.einsum)(equation, *operands)


@contextlib.contextmanager
def sharded_einsums():
    """For the span of the block, ``torch.einsum`` of two operands, one of
    them a DTensor, runs as :func:`sharded_einsum` (torch's own einsum
    flattens sharded dims into one matmul dim, which DTensor cannot
    always follow), and so does ``a @ w`` with a 2-D ``w``; every other
    call is torch's.  The layers call
    ``torch.einsum`` at call time, also when autograd recomputes a
    checkpointed layer, so the swap reaches them all."""
    import torch

    original = torch.einsum

    def einsum(equation, *operands):
        ops = operands
        if len(ops) == 1 and isinstance(ops[0], (list, tuple)):
            ops = tuple(ops[0])
        if len(ops) == 2 and any(is_dtensor(t) for t in ops):
            return sharded_einsum(equation, *ops)
        return original(equation, *operands)

    original_matmul = torch.Tensor.__matmul__

    def matmul(a, b):
        if (is_dtensor(a) or is_dtensor(b)) and b.ndim == 2 and a.ndim >= 2:
            lead = "abcdefgh"[:a.ndim - 1]
            return sharded_einsum(f"{lead}y,yz->{lead}z", a, b)
        return original_matmul(a, b)

    _EINSUM.append(original)
    torch.einsum, torch.Tensor.__matmul__ = einsum, matmul
    try:
        yield
    finally:
        torch.einsum, torch.Tensor.__matmul__ = original, original_matmul
        _EINSUM.pop()


def pick_last(logits, index):
    """``logits.gather(-1, index[..., None])[..., 0]``; on a mesh that
    splits the last dim (a vocab-parallel logit) each device picks the
    entries its shard holds, zero elsewhere, and the picks are summed
    over the split (one all-reduce of the picked values, not a gather of
    the logits)."""
    if not is_dtensor(logits):
        return logits.gather(-1, index[..., None])[..., 0]
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh, last = logits.device_mesh, logits.ndim - 1
    split = [m for m, p in enumerate(logits.placements)
             if isinstance(p, Shard) and p.dim == last and mesh.shape[m] > 1]
    if not split:
        return logits.gather(-1, index[..., None])[..., 0]
    if len(split) != 1:
        full = logits.redistribute(mesh, placements_of(logits, tuple(
            range(last))))
        return full.gather(-1, index[..., None])[..., 0]
    m = split[0]
    pl = placements_of(logits, tuple(range(last)) + (last,))
    lo = shard_offset(mesh, pl, logits.shape[-1], last)
    pi = tuple(Replicate() if i == m else p for i, p in enumerate(
        placements_of(logits, tuple(range(last)))))
    if not is_dtensor(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    out = tuple(Partial() if i == m else p for i, p in enumerate(pi))

    def pick(lg, ix):
        local = ix - lo
        inside = (local >= 0) & (local < lg.shape[-1])
        got = lg.gather(-1, local.clamp(0, lg.shape[-1] - 1)[..., None])[..., 0]
        return torch.where(inside, got, torch.zeros((), dtype=got.dtype))

    return local_call(pick, (logits, index), (pl, pi), out,
                      tuple(logits.shape[:-1]))


def whole_dim(x, dim: int):
    """``x`` with dim ``dim`` unsplit on its mesh (gathered where a mesh
    dim splits it); a plain tensor unchanged."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import Replicate, Shard

    want = tuple(Replicate() if isinstance(p, Shard) and p.dim == dim % x.ndim
                 else p for p in x.placements)
    return x if want == tuple(x.placements) else x.redistribute(
        x.device_mesh, want)


def shard_offset(mesh, placements, size: int, dim: int) -> int:
    """Where this device's shard of a dim of ``size`` entries starts under
    ``placements`` on ``mesh`` (split by one mesh dim, in chunks of
    ``ceil(size / n)``)."""
    from torch.distributed.tensor import Shard

    coord = mesh.get_coordinate()
    offset = 0
    for m, p in enumerate(placements):
        if isinstance(p, Shard) and p.dim == dim:
            size = -(-size // mesh.shape[m])
            offset += coord[m] * size
    return offset


def lookup_rows(table, index):
    """``table[index]`` (an embedding lookup); on a mesh each device looks
    up the rows its vocab shard holds, zero elsewhere, and the rows are
    summed over the vocab split at once (the embed dim gathered first, the
    index kept split over the batch where the vocab is not)."""
    if not is_dtensor(table):
        return table[index]
    import torch
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    pt = placements_of(table, (0,))
    split = {m for m, p in enumerate(pt) if isinstance(p, Shard) and
             mesh.shape[m] > 1}
    if not is_dtensor(index):
        index = DTensor.from_local(index, mesh, [Replicate()] * mesh.ndim,
                                   run_check=False)
    pi = tuple(Replicate() if m in split else p
               for m, p in enumerate(placements_of(index, (0,))))
    out = tuple(Partial() if m in split else p for m, p in enumerate(pi))
    lo = shard_offset(mesh, pt, table.shape[0], 0)

    def look(t, ix):
        if not split:
            return t[ix]
        local = ix - lo
        inside = (local >= 0) & (local < t.shape[0])
        rows = t[local.clamp(0, t.shape[0] - 1)]
        return torch.where(inside[..., None], rows, torch.zeros((), dtype=t.dtype))

    rows = local_call(look, (table, index), (pt, pi), out,
                      tuple(index.shape) + (table.shape[1],))
    return rows.redistribute(mesh, placements_of(rows, (0,)))
