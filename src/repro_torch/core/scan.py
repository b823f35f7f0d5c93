"""Device-resident loops: the port's counterpart of ``jax.lax.scan``.

The reference never runs its walk loops step by step from the host: they
are ``jax.lax.scan`` under ``jax.jit`` (``repro/core/engine.py``
``WalkEngine.run``, ``repro/walk_sgd/fleet.py`` ``_fleet_scan``), with the
state, the step counter ``t`` included, on the device.  :func:`scan` is
that loop in PyTorch.  A *step* maps a carry of tensors whose first entry
is ``t`` (a 0-d int64 tensor) to ``(next carry, per-step outputs)``; it
reads its per-step inputs by ``t`` (``index_select``), and :func:`scan`
writes the outputs into ``(T, ...)`` buffers at row ``t``
(``index_copy_``) and copies the next carry into the carry's buffers.

On CUDA tensors the loop is captured.  The first step runs on a side
stream (it builds the kernels' libraries, fills their caches and starts
cuBLAS); ``K`` steps are then captured on that stream into one
``torch.cuda.CUDAGraph`` and replayed ``R`` times (:func:`plan` picks
``K`` and ``R``), and the last ``T - 1 - R*K`` steps (fewer than ``K``)
run through the same step uncaptured: capturing them would cost more
host time than running them.  Every step that runs eagerly, and the
capture, run under ``torch.cuda.set_sync_debug_mode("error")``, so a step
that reads the device from the host raises.  The generators a step draws
from are registered with the graph, so the replays draw what the
uncaptured loop draws and leave each generator in the same state.  A
capture or replay that fails raises: nothing falls back to the
uncaptured loop.  ``capture=False`` runs the uncaptured loop on the card
for comparison only.  On the CPU the same step runs as a plain loop.

Launch counts (``kernels._launch.COUNTED``) stay the launches the card
ran: the capture's own increments are taken back, and each replay adds
the launches the graph holds.

A graph lives inside one :func:`scan` call and dies with it.  Across an
edge churn (``WalkEngine.apply_churn``, which builds new buffers) the
next loop is a new call and captures again, so no graph is ever replayed
over the buffers of an earlier graph version (``run_dada``'s rounds).
"""
from __future__ import annotations

import contextlib
import dataclasses
import time
from typing import Callable, Optional, Sequence, Tuple

import torch

__all__ = ["MIN_REPLAYS", "MAX_CHUNK", "ScanStats", "plan", "scan"]

# Replays of a graph at least, and steps a graph holds at most.  Capturing
# costs 1.5-1.7x the host time of K uncaptured steps, while a replayed
# step is no faster in a longer graph (Fig. 3's loop on an H100: 0.131-
# 0.132 ms a step at K = 2 to 32, 0.143 at 250; chip_smoke.py phase 9,
# PERF.md) and a replay's launch costs the host microseconds.
MIN_REPLAYS = 8
MAX_CHUNK = 8


@dataclasses.dataclass
class ScanStats:
    """What one :func:`scan` call did: ``chunk`` steps a graph (0 when
    uncaptured), its ``replays``, the uncaptured ``tail``, the host
    seconds of the capture and instantiation (``capture_s``), CUDA
    events around the replays and the tail (:meth:`replay_ms`), and why
    a loop on the card ran uncaptured when its caller said so
    (``uncaptured_by``, e.g. a gloo walker mesh)."""

    steps: int
    captured: bool
    uncaptured_by: Optional[str] = None
    chunk: int = 0
    replays: int = 0
    tail: int = 0
    capture_s: float = 0.0
    events: Optional[Tuple[torch.cuda.Event, torch.cuda.Event]] = None

    def replay_ms(self) -> Optional[float]:
        """Device milliseconds from the first replay to the end of the
        tail (waits for the second event)."""
        if self.events is None:
            return None
        self.events[1].synchronize()
        return self.events[0].elapsed_time(self.events[1])


def plan(num_steps: int, chunk: Optional[int] = None) -> Tuple[int, int, int]:
    """``(K, R, tail)`` for the ``n = num_steps - 1`` steps after the
    first: graphs of ``K = n // max(MIN_REPLAYS, ceil(n / MAX_CHUNK))``
    steps (``chunk`` when given), ``R = n // K`` replays, and the ``n % K``
    steps left uncaptured."""
    n = num_steps - 1
    if n <= 0:
        return 0, 0, 0
    if chunk is None:
        chunk = n // max(MIN_REPLAYS, -(-n // MAX_CHUNK))
    k = max(1, min(chunk, n))
    return k, n // k, n % k


@contextlib.contextmanager
def _no_host_reads():
    old = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(old)


def _advance(step: Callable, state: tuple, bufs: tuple) -> None:
    """One step: outputs to row ``t`` of ``bufs``, then the next carry
    into ``state`` (stream order puts the row's read before ``t``'s
    update)."""
    new, outs = step(state)
    row = state[0].view(1)
    for buf, out in zip(bufs, outs):
        buf.index_copy_(0, row, out.unsqueeze(0))
    for s, n in zip(state, new):
        s.copy_(n)


def scan(
    step: Callable,
    carry: Sequence[torch.Tensor],
    num_steps: int,
    out_like: Sequence[torch.Tensor],
    *,
    capture: Optional[bool] = None,
    chunk: Optional[int] = None,
    generators: Sequence[torch.Generator] = (),
    uncaptured_by: Optional[str] = None,
) -> tuple:
    """Run ``step`` ``num_steps`` times from ``carry``.

    ``carry[0]`` is the step counter ``t``, a 0-d int64 tensor; ``step``
    returns the next carry (same shapes and dtypes) and a tuple of
    outputs shaped and typed like ``out_like``.  ``capture`` (default:
    on CUDA tensors) captures the loop in CUDA graphs of ``chunk`` steps
    (default :func:`plan`'s); ``generators`` are the CUDA generators the
    step draws from; ``uncaptured_by`` is the caller's reason for
    ``capture=False``, kept in the stats.  The inputs are not modified.
    Returns ``(outputs,
    final carry, stats)``: each output stacked ``(num_steps, ...)``, and
    a :class:`ScanStats`.
    """
    device = carry[0].device
    if capture is None:
        capture = device.type == "cuda"
    if capture and device.type != "cuda":
        raise ValueError("capture needs the carry on a CUDA device")
    state = tuple(c.clone() for c in carry)
    bufs = tuple(
        torch.empty((num_steps, *x.shape), dtype=x.dtype, device=x.device)
        for x in out_like
    )
    if not capture or num_steps == 0:
        for _ in range(num_steps):
            _advance(step, state, bufs)
        return bufs, state, ScanStats(steps=num_steps, captured=False,
                                      uncaptured_by=uncaptured_by)

    from repro_torch.kernels._launch import COUNTED

    k, replays, tail = plan(num_steps, chunk)
    stats = ScanStats(steps=num_steps, captured=True, chunk=k,
                      replays=replays, tail=tail)
    current = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)
    side.wait_stream(current)
    with torch.cuda.stream(side):
        with _no_host_reads():
            _advance(step, state, bufs)  # the first step is the warm-up
        if k:
            graph = torch.cuda.CUDAGraph()
            for gen in generators:
                graph.register_generator_state(gen)
            before = [fn.launches for fn in COUNTED]
            t0 = time.perf_counter()
            with torch.profiler.record_function("scan.capture"):
                graph.capture_begin()
                try:
                    with _no_host_reads():
                        for _ in range(k):
                            _advance(step, state, bufs)
                finally:
                    graph.capture_end()
            stats.capture_s = time.perf_counter() - t0
            held = [fn.launches - b for fn, b in zip(COUNTED, before)]
            for fn, b in zip(COUNTED, before):
                fn.launches = b  # the capture launched nothing
            stats.events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            with torch.profiler.record_function("scan.replay"):
                stats.events[0].record()
                for _ in range(replays):
                    graph.replay()
                    for fn, n in zip(COUNTED, held):
                        fn.launches += n
                with _no_host_reads():
                    for _ in range(tail):
                        _advance(step, state, bufs)
                stats.events[1].record()
    current.wait_stream(side)
    return bufs, state, stats
