"""Per-device cost of a step, counted op by op as it runs (the roofline's
source; the JAX package's ``utils/hlo_cost.py`` prices compiled HLO text).

:func:`count_ops` is a ``TorchDispatchMode``: every ATen op that runs
inside it adds to an :class:`OpCost` (the fields, ``+`` and ``*`` of the
reference's ``HloCost``):

* FLOPs.  Matrix products and convolutions by torch's own formulas
  (``torch.utils.flop_counter``), as the reference prices ``dot`` and
  ``convolution`` from their contracting and window dims; a reduction
  1 per input element; a sort ``n * bit_length(n)`` over its ``n``
  output elements; the ops of :data:`_ZERO_FLOP_OPS` (layout, copies,
  casts, gathers, scatters, selects, fills, random draws) 0; a softmax
  5 per element and a SiLU 2 (the reduce, subtract, exp, reduce and
  divide, the logistic and multiply, that the reference's lowering of
  ``jax.nn.softmax`` and ``jax.nn.silu`` counts); every other op 1 per
  output element.
* Bytes.  Operand bytes plus output bytes of each op; views and
  metadata (:data:`_FREE_BYTE_OPS`) are free, an allocation writes its
  output, a gather reads twice its output and its indices.  This is the
  traffic of eager ops: the port runs no fusion, so unlike the
  reference's count (which assumes XLA fused producers into consumers)
  an intermediate is written by one op and read again by the next.

There is no trip count to recover: eager Python runs every layer.

Counts are per device.  Under ``torch.distributed.tensor`` the counter
defers a DTensor op to DTensor (as ``CommDebugMode`` does) and counts the
local ops it runs on this device's shards, and the collectives of its
redistributions (:mod:`repro_torch.utils.collectives` summarises those
from a ``CommDebugMode``).  DTensor's own shape propagation, which runs
the op once at the global shapes, is not counted.

Priced regions.  The port's kernel dispatchers (attention, the SSD scan,
RMSNorm, the walk steps) run their call inside :func:`priced`: the call
adds one analytic cost (``repro_torch.utils.kernel_bounds``) and its body
is not counted op by op, so a step counts the same work whether the CUDA
kernel or its plain version runs.  On real tensors the body runs as it
did; on fake tensors (``FakeTensorMode``) it does not run, and the region
returns empty outputs of the right shapes and dtypes.

With ``track_memory=True`` the counter also follows the storages the
step allocates: ``peak_bytes`` is the most bytes of them alive at once,
``live_bytes`` those alive at the end (per device, the local shards).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Callable, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

__all__ = ["OpCost", "OpCounter", "count_ops", "priced"]


@dataclasses.dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    coll_bytes: float = 0.0
    coll_ring_bytes: float = 0.0
    coll_counts: Optional[Dict[str, float]] = None

    def __add__(self, o: "OpCost") -> "OpCost":
        counts = dict(self.coll_counts or {})
        for k, v in (o.coll_counts or {}).items():
            counts[k] = counts.get(k, 0) + v
        return OpCost(
            self.flops + o.flops,
            self.bytes + o.bytes,
            self.coll_bytes + o.coll_bytes,
            self.coll_ring_bytes + o.coll_ring_bytes,
            counts,
        )

    def __mul__(self, k: float) -> "OpCost":
        return OpCost(
            self.flops * k, self.bytes * k, self.coll_bytes * k,
            self.coll_ring_bytes * k,
            {kk: v * k for kk, v in (self.coll_counts or {}).items()},
        )


# layout, copies, casts, indexing, selects, fills and random draws: no
# arithmetic (the reference's _ZERO_FLOP_OPS, by ATen name)
_ZERO_FLOP_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "expand_as", "squeeze", "unsqueeze", "flatten",
    "unflatten", "select", "slice", "narrow", "as_strided", "alias",
    "detach", "lift_fresh", "lift_fresh_copy", "split", "split_with_sizes",
    "unbind", "chunk", "diagonal", "unfold", "movedim", "view_as",
    "contiguous", "clone", "copy", "copy_", "_to_copy", "_copy_from",
    "_copy_from_and_resize", "cat", "stack", "constant_pad_nd", "pad",
    "repeat", "repeat_interleave", "flip", "roll", "tril", "triu", "where",
    "masked_fill", "masked_fill_", "index", "_unsafe_index", "index_select",
    "gather", "scatter", "scatter_", "index_put", "index_put_",
    "_index_put_impl_", "embedding", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "zeros",
    "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full",
    "full_like", "new_full", "fill", "fill_", "zero_", "arange", "scalar_tensor",
    "rand", "rand_like", "randn", "randn_like", "randint", "uniform_",
    "normal_", "random_", "bernoulli_", "exponential_", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type", "set_",
    "resize_", "nonzero", "_assert_async", "_assert_scalar",
    "_unsafe_index_put", "view_as_real", "view_as_complex", "one_hot",
    "select_scatter", "slice_scatter", "diagonal_scatter",
    "as_strided_scatter", "_foreach_copy_",
})

# ops that move no data: views and metadata (the reference's _FREE_BYTE_OPS)
_FREE_BYTE_OPS = frozenset({
    "view", "_unsafe_view", "reshape", "_reshape_alias", "t", "transpose",
    "permute", "expand", "expand_as", "squeeze", "unsqueeze", "flatten",
    "unflatten", "select", "slice", "narrow", "as_strided", "alias",
    "detach", "lift_fresh", "split", "split_with_sizes", "unbind", "chunk",
    "diagonal", "unfold", "movedim", "view_as", "empty", "empty_like",
    "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "sym_size", "sym_stride", "sym_numel", "sym_storage_offset",
    "is_same_size", "_has_compatible_shallow_copy_type", "set_", "resize_",
    "_assert_async", "_assert_scalar", "view_as_real", "view_as_complex",
})

# allocations that write their output and read nothing
_FACTORY_OPS = frozenset({
    "zeros", "zeros_like", "new_zeros", "ones", "ones_like", "new_ones",
    "full", "full_like", "new_full", "arange", "scalar_tensor", "rand",
    "rand_like", "randn", "randn_like", "randint",
})

# windowed reads: twice the output plus the indices (the reference's gather)
_GATHER_OPS = frozenset({"index", "_unsafe_index", "index_select", "gather",
                         "embedding"})

_REDUCTION_OPS = frozenset({
    "sum", "mean", "amax", "amin", "prod", "var", "std", "var_mean",
    "std_mean", "norm", "linalg_vector_norm", "logsumexp", "argmax",
    "argmin", "any", "all", "cumsum", "cumprod", "count_nonzero", "nansum",
    "aminmax", "max", "min", "_foreach_norm",
})

# one ATen op the reference's lowering counts as several elementwise ops
_ELEMENTWISE_WEIGHT = {"_softmax": 5, "_log_softmax": 5, "silu": 2,
                       "_softmax_backward_data": 4, "silu_backward": 4}

_SORT_OPS = frozenset({"sort", "topk", "argsort"})


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _flops(name: str, overload: str, func, args, kwargs, out, ins, outs):
    from torch.utils.flop_counter import flop_registry

    packet = func._overloadpacket
    if packet in flop_registry:
        return float(flop_registry[packet](*args, **kwargs, out_val=out))
    if name in _ZERO_FLOP_OPS:
        return 0.0
    if name in _SORT_OPS:
        n = sum(t.numel() for t in outs)
        return float(n * max(1, n.bit_length()))
    if name in _REDUCTION_OPS and not (name in ("max", "min")
                                       and overload == "other"):
        return float(ins[0].numel()) if ins else 0.0
    weight = _ELEMENTWISE_WEIGHT.get(name, 1)
    if name.startswith("_foreach_"):
        return float(weight * sum(t.numel() for t in outs))
    return float(weight * (outs[0].numel() if outs else 0))


def _bytes(name: str, ins, outs) -> float:
    if name in _FREE_BYTE_OPS:
        return 0.0
    out_b = sum(_nbytes(t) for t in outs)
    if name in _FACTORY_OPS:
        return float(out_b)
    if name in _GATHER_OPS:
        idx = sum(_nbytes(t) for t in ins[1:] if not t.is_floating_point())
        return float(2 * out_b + idx)
    return float(out_b + sum(_nbytes(t) for t in ins))


_COUNTERS: list = []


def _active_counter() -> Optional["OpCounter"]:
    """The innermost :func:`count_ops` counter, or None."""
    return _COUNTERS[-1] if _COUNTERS else None


class OpCounter(TorchDispatchMode):
    """The mode :func:`count_ops` enters; ``cost`` is its running count,
    ``by_op`` the FLOPs per ATen op name, ``peak_bytes`` and
    ``live_bytes`` the storages it saw allocated (``track_memory``)."""

    def __init__(self, track_memory: bool = False, price_regions: bool = True):
        super().__init__()
        self.price_regions = price_regions
        self.cost = OpCost(coll_counts={})
        self.by_op: Dict[str, float] = {}
        self.track_memory = track_memory
        self.live_bytes = 0
        self.peak_bytes = 0
        self._suspended = 0
        self._known: Dict[int, weakref.ref] = {}
        self._new: Dict[int, int] = {}

    # -- memory ---------------------------------------------------------
    def _storage(self, t):
        try:
            return t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None

    def _see_input(self, t) -> None:
        st = self._storage(t)
        if st is not None and id(st) not in self._known:
            self._known[id(st)] = weakref.ref(st, self._forget(id(st)))

    def _forget(self, key: int):
        def cb(_):
            self._known.pop(key, None)
            self.live_bytes -= self._new.pop(key, 0)
        return cb

    def _see_output(self, t) -> None:
        st = self._storage(t)
        if st is None or id(st) in self._known:
            return
        self._known[id(st)] = weakref.ref(st, self._forget(id(st)))
        self._new[id(st)] = st.nbytes()
        self.live_bytes += st.nbytes()
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    # -- counting -------------------------------------------------------
    def add(self, cost: OpCost, name: str) -> None:
        """Add ``cost`` (a priced region's) to the count."""
        self.cost = self.cost + cost
        self.by_op[name] = self.by_op.get(name, 0.0) + cost.flops

    @contextlib.contextmanager
    def suspended(self):
        """Count no op inside (a priced region's body)."""
        self._suspended += 1
        try:
            yield
        finally:
            self._suspended -= 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(getattr(t, "__name__", "") == "DTensor" for t in types):
            return NotImplemented  # let DTensor run; count its local ops
        if _PROPAGATING[0] or isinstance(func, torch._ops.HigherOrderOperator):
            return func(*args, **kwargs)
        ins = _tensors((args, kwargs))
        if self.track_memory:
            for t in ins:
                self._see_input(t)
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if self.track_memory:
            for t in outs:
                self._see_output(t)
        if self._suspended:
            return out
        if func.namespace in ("_c10d_functional", "c10d_functional",
                              "_dtensor", "prim"):  # collectives, metadata
            return out
        name = func._overloadpacket.__name__
        flops = _flops(name, func._overloadname, func, args, kwargs, out,
                       ins, outs)
        self.cost.flops += flops
        self.cost.bytes += _bytes(name, ins, outs)
        if flops:
            self.by_op[name] = self.by_op.get(name, 0.0) + flops
        return out


# DTensor's sharding propagator runs each new op once on global-shaped
# fake tensors to learn its output's metadata: set while it does.
_PROPAGATING = [0]


@contextlib.contextmanager
def _no_propagation_counts():
    try:
        from torch.distributed.tensor._sharding_prop import ShardingPropagator
    except ImportError:  # a build without torch.distributed
        yield
        return
    # the uncached body where torch has one, else the cached entry (its
    # body runs on a cache miss only, which is when it runs the op)
    name = next((n for n in ("_propagate_tensor_meta_non_cached",
                             "_propagate_tensor_meta")
                 if n in ShardingPropagator.__dict__), None)
    if name is None:
        yield
        return
    original = ShardingPropagator.__dict__[name]

    def wrapped(self, *a, **k):
        _PROPAGATING[0] += 1
        try:
            return original(self, *a, **k)
        finally:
            _PROPAGATING[0] -= 1

    setattr(ShardingPropagator, name, wrapped)
    try:
        yield
    finally:
        setattr(ShardingPropagator, name, original)


@contextlib.contextmanager
def count_ops(track_memory: bool = False, price_regions: bool = True):
    """Count the ops run inside; yields the :class:`OpCounter`.  With
    ``price_regions=False`` a priced call's body is counted op by op
    instead (on real tensors: the comparison with an op-level count such
    as the reference's)."""
    counter = OpCounter(track_memory=track_memory, price_regions=price_regions)
    _COUNTERS.append(counter)
    try:
        with _no_propagation_counts(), counter:
            yield counter
    finally:
        _COUNTERS.remove(counter)


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


def _is_fake(*tensors) -> bool:
    """Any of ``tensors`` is a fake tensor (``FakeTensorMode``)."""
    from torch._subclasses.fake_tensor import is_fake

    return any(isinstance(t, torch.Tensor) and is_fake(t) for t in tensors)


class _FakeCall(torch.autograd.Function):
    """A priced call's stand-in on fake tensors that keeps its inputs in
    the autograd graph; its backward is priced at twice the forward (the
    two products of each forward product) and returns zeros."""

    @staticmethod
    def forward(ctx, name, price, make, *inputs):
        ctx.name, ctx.price = name, price
        ctx.metas = [(t.shape, t.dtype, t.device) for t in inputs]
        return make()

    @staticmethod
    def backward(ctx, *grads):
        counter = _active_counter()
        if counter is not None and not counter._suspended:
            counter.add(ctx.price * 2.0, ctx.name + "_backward")
        return (None, None, None) + tuple(
            torch.zeros(shape, dtype=dtype, device=device)
            if dtype.is_floating_point else None
            for shape, dtype, device in ctx.metas)


def priced(name: str, cost: Callable[[], tuple], run: Callable,
           fake: Callable, *tensors):
    """One kernel call counted as one analytic cost.

    ``cost()`` gives ``(bytes, flops)`` (``repro_torch.utils.kernel_bounds``
    order), evaluated on real host tensors; ``run()`` is the call;
    ``fake()`` makes its outputs' empty stand-ins; ``tensors`` are the
    call's tensor inputs.  Under a counter the cost is added and ``run``'s
    ops are not counted (its backward, on real tensors, is counted op by
    op); when the inputs are fake, ``fake()``'s outputs are returned in
    ``run``'s place, still in the autograd graph of the inputs.  Without a
    counter on real tensors this is ``run()``.
    """
    counter = _active_counter()
    fake_inputs = _fake_mode_active() and _is_fake(*tensors)
    if counter is not None and not counter.price_regions and not fake_inputs:
        return run()
    if counter is None or counter._suspended:  # none, or inside a region
        return _fake_out(name, OpCost(), fake, tensors) if fake_inputs else run()
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with counter.suspended(), unset_fake_temporarily():
        nbytes, flops = cost()
    price = OpCost(float(flops), float(nbytes))
    counter.add(price, name)
    with counter.suspended():
        return _fake_out(name, price, fake, tensors) if fake_inputs else run()


def _fake_out(name, price, fake, tensors):
    inputs = [t for t in tensors if isinstance(t, torch.Tensor)]
    if torch.is_grad_enabled() and any(t.requires_grad for t in inputs):
        return _FakeCall.apply(name, price, fake, *inputs)
    return fake()
