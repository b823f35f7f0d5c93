"""Collective traffic of a traced step (the JAX package's
``utils/hlo_parse.py``, which reads it from partitioned HLO text).

:class:`CollectiveTrace` is a ``CommDebugMode`` that also keeps, for each
collective DTensor issues, its kind, its bytes on this device and the size
of its process group (the size of the mesh dimension it runs over).
:func:`collective_summary` sums them under the reference's keys; each
collective's ring cost (the bytes serialised on the slowest link of a
ring) takes the reference's ``hlo_cost._ring_cost`` weights:

    all-reduce       2 * bytes * (g-1)/g
    all-gather       bytes * (g-1)/g
    reduce-scatter   bytes * (g-1)/g
    all-to-all       bytes * (g-1)/g
    others           bytes

with ``bytes`` the larger of the operand's and the result's, per device.
"""
from __future__ import annotations

from collections import defaultdict

__all__ = ["CollectiveTrace", "collective_summary", "ring_cost"]

# functional-collective op name -> the reference's collective kind
_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "broadcast",
    "broadcast_": "broadcast",
}


def ring_cost(kind: str, nbytes: float, group_size: int) -> float:
    """Ring-cost bytes of one collective (``hlo_cost._ring_cost``)."""
    k = max(2, group_size)
    if kind == "all-reduce":
        return 2.0 * nbytes * (k - 1) / k
    if kind in ("all-gather", "reduce-scatter", "all-to-all"):
        return nbytes * (k - 1) / k
    return float(nbytes)


def _trace_class():
    import torch
    from torch.distributed.distributed_c10d import _resolve_process_group
    from torch.distributed.tensor.debug import CommDebugMode
    from torch.utils._pytree import tree_flatten

    def nbytes(tree) -> int:
        return sum(t.numel() * t.element_size() for t in tree_flatten(tree)[0]
                   if isinstance(t, torch.Tensor))

    class _CollectiveTrace(CommDebugMode):
        """A ``CommDebugMode`` whose ``collectives`` lists, per collective,
        ``{"kind", "bytes", "group"}``."""

        def __init__(self):
            super().__init__()
            self.collectives = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = super().__torch_dispatch__(func, types, args, kwargs)
            if out is NotImplemented or not hasattr(func, "_overloadpacket"):
                return out
            name = func._overloadpacket.__name__
            if func.namespace in ("_c10d_functional", "c10d_functional") \
                    and name in _KINDS:
                group = next(a for a in reversed(args) if isinstance(a, str))
                size = _resolve_process_group(group).size()
                self.collectives.append({
                    "kind": _KINDS[name],
                    "bytes": max(nbytes(args), nbytes(out)),
                    "group": size,
                })
            return out

    return _CollectiveTrace


def CollectiveTrace():  # noqa: N802  (a class, built on first use)
    """A new trace mode (``with CollectiveTrace() as trace: ...``).  The
    class is made on first use, so importing this module touches no part
    of ``torch.distributed``."""
    global _CLASS
    if _CLASS is None:
        _CLASS = _trace_class()
    return _CLASS()


_CLASS = None


def collective_summary(trace) -> dict:
    """The reference's summary of a :func:`CollectiveTrace`:
    ``total_bytes``, ``total_ring_cost_bytes``, ``num_ops`` and ``by_kind``
    (``count``, ``bytes``, ``ring_cost_bytes`` per kind); and
    ``by_group``, the ring-cost bytes per group size (a key the reference
    lacks: which link a collective crosses depends on its group's size,
    ``repro_torch.launch.mesh.HW.link_bw``)."""
    by_kind = defaultdict(lambda: {"count": 0, "bytes": 0, "ring_cost_bytes": 0.0})
    by_group = defaultdict(float)
    total, ring = 0, 0.0
    for op in trace.collectives:
        cost = ring_cost(op["kind"], op["bytes"], op["group"])
        k = by_kind[op["kind"]]
        k["count"] += 1
        k["bytes"] += op["bytes"]
        k["ring_cost_bytes"] += cost
        by_group[str(op["group"])] += cost
        total += op["bytes"]
        ring += cost
    return {
        "total_bytes": int(total),
        "total_ring_cost_bytes": float(ring),
        "num_ops": len(trace.collectives),
        "by_kind": {k: dict(v) for k, v in by_kind.items()},
        "by_group": dict(by_group),
    }
