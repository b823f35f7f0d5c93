"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, started together; ptxas' registers, spills and
warnings are printed, and ``cuobjdump -sass`` must find HGMMA in the bf16
flash-attention library and HMMA or HGMMA in the bf16 SSD library), then:

1. holds ``walk_transition_ragged`` against its plain PyTorch version on
   the card, on ``barabasi_albert(1_000_000, 3)`` (ragged, ~7 M directed
   edges) with W=8192 walks and MHLJParams(0.1, 0.5, 3), at p_J = 0.1, 0
   and 1 (W/16+1 walks on the hub) and with every walk on the hub, then
   at W=257 with r=1 and r=5, and measures over 10^6 draws how often the
   kernel's Lévy distance d differs from PyTorch's on the card and on the
   CPU;
2. runs ``WalkEngine.run`` for 200 steps on that graph on its default
   path, captured in CUDA graphs (``repro_torch.core.scan``), and once
   more uncaptured from the same generator state: walks, hops, overflow
   vector and generator state bit for bit, launches counted on the
   captured run, each loop's ms/step, the graphs' K and capture time,
   and the idle share of a 97-step profiled window of each loop (the
   captured one after its capture); the walks' digest must equal ``WALK_DIGESTS``;
   then the kernel's own time replayed on the run's inputs, a 50-step
   uncaptured run under ``torch.profiler``, and what the kernel's time
   is made of: the launch floor (a
   one-element ``add_``), the latency of one dependent load (the slope of
   132 all-jumping walks' time over r = 1 … 16 hops), the chain bound (the
   longest chain of dependent loads the step forces, times that latency)
   beside the bytes bound, the kernel at p_J = 0, 0.1 and 1 on the run's
   nodes, and at every lane-group width (``kernel.RAGGED_GROUPS``), each
   by events and by CUPTI;
3. trains ``run_rw_sgd_multi("mhlj", ...)`` on ``barabasi_albert(100_000,
   3)`` with W=2048, avg_every=50, 500 steps (captured), runs its loop
   again uncaptured from the same generator state (update nodes, hops,
   MSE traces and models bit for bit; ms/step, K, capture time and idle
   share of each, as in 2), replays every step's exact kernel inputs
   through the kernel and its plain version, times the kernel on them as
   in 2 (the hop slope on this graph), and checks the trainer against
   its CPU run on a small input;
4. on ``barabasi_albert(100_000, 3)`` as a ``CSRGraph`` (max degree 1196)
   with W=2048, builds the engine of every layout of the reference's
   ``benchmarks/large_graph_walk.py`` (sparse, dense, bucketed,
   bucketed_compact, bucketed_compact_f4) and ragged, holds
   ``walk_transition_sparse`` (on the sparse tiles and on every compacted
   bucket tile) and ``walk_transition`` against their plain versions on
   one injected block at W = 1, 257, 2048 and r = 1, 3, 5, runs each
   engine for 200 steps captured and uncaptured as in 2 (launches,
   walk-steps/s, compaction overflow rate, idle shares; a compacted step
   launches the sparse kernel twice a bucket: its compacted passes and
   the full dispatch's, gated off by the device's overflow flag, whose
   cost is timed apart), checks that all six layouts give the
   same ``(next, hops)`` on the same blocks, and times both kernels (the
   sparse one also at every bucket width, on the bucketed engine's (W,
   width) tiles and the compacted engine's (cap, width) tiles) beside
   their bytes bounds and their longest dependent chains (the most
   nonzero entries a row adds; the dense kernel's hop loads), and logs a
   digest of the sparse engine's 200-step walks, which another commit's
   run can be checked against;
5. trains ``run_rw_sgd_multi("mhlj", ...)`` as in 3 on that graph given as
   a ``CSRGraph`` (sparse layout), as a ``BucketedCSRGraph`` (compacted)
   and with ``engine_kwargs={"layout": "dense"}``: launches per run, the
   captured loop against the uncaptured one as in 3, the walk-steps that
   differ from the ragged run of 3, ``avg_mse`` at the least-squares
   floor, and every step replayed through kernel and plain version.
6.-8. the LLM slice, per model, each built once at full width in bf16
   with random weights from seed 0 (minitron-8b, then mamba2-370m, freed
   in between): 6. its kernel against its plain version at the path's
   shapes — ``flash_attention``'s bf16 route (``wgmma_bf16``) on
   minitron's layer-0 q/k/v (B=1, S=4096, N=32, K=8, h=128, causal), at
   S=4000 and at h=64, its float32 route (``cuda_core_f32``) on a small
   shape, and both routes timed at minitron's shape (TFLOP/s, share of the
   bound); ``ssd_scan``'s bf16 route (``mma_bf16``) on mamba2's layer-0
   inputs (B=4, L=4096, H=32, P=64, N=128, chunk 256) and at L=4000
   through the padding, its float32 route (``cuda_core_f32``) on the same
   inputs upcast, each route's error against the float64 result, both
   routes timed (share of the bound, the bytes the bf16 design moves, its
   three launches apart under the profiler) and ``ops._head_major``'s
   copies apart — with device times, bounds, the
   plain version's time and SDPA's; 7. prefill
   (``apply``, minitron B=1x4096, mamba2 B=4x4096) with
   ``use_kernels=True``: launches (one kernel per layer; minitron's 32 on
   the bf16 flash route, mamba2's 48 on the ``mma_bf16`` SSD route),
   tokens/s, peak memory, the relative Frobenius error
   against the einsum path on the same weights, and ``ops.rmsnorm``
   (``rmsnorm_fused``) on the result;
   8. ``ServeEngine(batch_size=4, cache_len=256)`` answering the
   standalone demo's 8 requests (all must complete), and the reduced
   model's greedy tokens on the card against its CPU run; then 7 again
   with the weights upcast to float32 (minitron's 32 and mamba2's 48
   launches on the float32 routes): kernel path against einsum path
   (<= 2e-4), and each
   bf16 run against the float32 einsum run; then ``rmsnorm_fused``
   against its plain version and ``F.rms_norm`` at (4096, 4096) and
   (16384, 1024) in bf16 and float32, with the kernel that ran and the
   share of the bound;
9. the paper's reproduction, ``repro_torch.paper``, on the card at the
   paper's graph sizes (Fig. 3 ring(1000), T = 40,000; Fig. 4 ER(1000,
   0.1), T = 20,000; Fig. 5's five 1000-node graphs; Fig. 6 ring(64), six
   replicas; Theorem 1 at n = 128), every loop captured: first the first
   2,000 steps of Fig. 3's mhlj run at W=1, captured and uncaptured (bit
   for bit; ms/step, K, capture time), 4,001 steps of it at each graph
   length K of ``PAPER_K_SWEEP`` (capture time, ms/step), and 500 steps
   of each loop profiled (idle share); then the figures one unit (a
   figure, or Fig. 5 on one graph) after another in this process, beside
   the estimate of a side-by-side plan; Fig. 5's T and then Fig.
   6's are cut, never below 20,000, only where the measured ms/step says
   the phase would pass ~5 minutes (each cut is printed); each figure's
   wall time, ms/step, K, capture time and
   ``walk_transition_sparse`` launches (one per training step, checked);
   Fig. 3's and Fig. 5's BA(1000,3) mhlj runs take uniform blocks drawn on
   the card, and their first 2,000 steps are replayed on the CPU plain path
   (update nodes and hops equal, bit for bit); every MSE trace must be
   finite, and the claims the reference's tests assert are hard gates
   (Fig. 3's entrapment, early ratio and Remark-1 overhead; Theorem 1's
   tau ratios and Remark 1; Fig. 6's shrinking gaps, final slope and
   ``gap_shrink``), the others are printed with the claim they bear on;
10. the other chain laws and the fault path (aim ``PHASE10_AIM_S``):
   (a) ``repro_torch.paper.law_sweep`` at the reference's full tier (BA(1000,3),
   dumbbell(128,64), lollipop(256,128); seven laws; W=1 on the sparse
   layout, one sparse launch a step, checked; T = 40,000, cut only past
   ``LAWS_AIM_S``, never below 15,000, each cut printed), every
   ``{family}_{law}_herfindahl`` beside ``results/BENCH_law_sweep.json``'s
   and finite, a card-drawn 2,000-step heterogeneity run replayed on the
   CPU bit for bit; (b) phase 3's trainer (BA(100k,3) ragged, W=2048,
   avg_every=50, 500 steps) under the private law (gamma 0.1) and the
   heterogeneity law with a stand-in pi passed through ``law_kwargs``, and,
   under MHLJ, under Markov faults (5% crash, 2% recovery, patience 2)
   with the rescue on and off and under the 10 top hubs killed with an
   edge window over the cut ``id < n/2``: each captured against
   uncaptured bit for bit (with the fault state, the rescue and blocked
   totals and the generator), ms/step, idle share, no rescue with it off,
   and ``edge_slot_lookup`` alone (time, peak memory); (c) a kill at step
   250 of the Markov run, ``save_fleet_checkpoint`` (models, FaultState
   and generator state as extras), ``load_fleet_checkpoint`` and the rest:
   equal to the uninterrupted run bit for bit; (d) the fault sweep's
   training leg at its full scale, its criterion beside
   ``results/BENCH_faults.json``'s, the rescue-off ratio above the
   rescue-on one at 5% on both families gated; (e) Fig. 6's
   ``annealed_vs_const`` on four more card streams (reported);
11. dynamic graphs (aim ``PHASE11_AIM_S``): (a) the reference's churn
   sweep at its full tier (``benchmarks/large_graph_walk.py``
   ``_churn_sweep``: BA(100k,3) ragged, Lipschitz ``exp(N(0,1))`` from
   seed 5, one batch of 0.1% of the undirected edges, half deletes between
   nodes of degree >= 4, halved and retried on a disconnect, half
   inserts) the incremental way (``apply_edge_churn`` +
   ``WalkEngine.apply_churn``) and as a rebuild (``from_edges`` +
   ``from_graph``), each warmed once and timed the second time: the
   patched CDF equals the card's rebuild and the CPU's patch bit for bit;
   touched rows, both times and their ratio; (b) the ragged kernel against
   its plain version on the churned buffers, W=2048 for 200 steps
   captured and uncaptured from one generator state (walks, hops,
   generator bit for bit), and one post-churn step of fresh sparse, dense
   and bucketed engines equal to the ragged one; (c) phase 3's trainer
   (W=2048, avg_every 50, MHLJ(0.1, 0.5, 3)) 500 steps, the batch of (a),
   ``WalkFleet.migrate``, 500 more steps: each segment captured ==
   uncaptured bit for bit (models and ``avg_mse`` too), the replayed
   ms/step before and after, the re-capture seconds, the walks displaced;
   (d) ``run_dada`` on BA(2000,3) (4 rounds x 500 steps, W=64, k=3,
   avg_every 25): captured == ``capture=False``, a kill after round 2 and
   a resume from its checkpoint == the uninterrupted run, the card's
   per-round blocks replayed on the CPU (edges, displaced walks, graph
   versions, update nodes equal), wall seconds per round of the walk,
   personalization, similarity and churn; (e) ``core.torch_sampling``:
   BA(100k,3) edges and an SBM 4x250 from injected uniforms, card == CPU.

Kernel times by CUDA events come from :func:`device_time_ms`: each chunk
of timed calls waits behind ``csrc/stream_hold.cu``, a one-thread kernel
that spins until the host sets a pinned flag after the chunk's last
launch, so no host time enters a call's events.  The script prints its
total time.

Prints one line per phase, the card's name and power limit, one JSON line
of kernel measurements, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the exit
code is non-zero.  Without a CUDA device it exits non-zero and prints no
result.  Full numbers also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth, the
# float32 rate outside the tensor cores and the dense bf16 tensor-core rate.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
SECTOR = 32
# the walks' digests of phase 2's engine, phase 3's trainer and phase 4's
# sparse engine, as the uncaptured loops of earlier commits logged them:
# the captured loops draw the same streams, so a run that differs fails
WALK_DIGESTS = {"engine": "0443043a29af39ff", "trainer": "55247e8bcd26b353",
                "sparse": "f8330f2ef8b68117"}


def log(msg: str) -> None:
    print(msg, flush=True)


def digest(*arrays) -> str:
    """A short digest of walks, which another commit's run can be checked
    against."""
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


def check_digest(name: str, value: str) -> str:
    if value != WALK_DIGESTS[name]:
        raise AssertionError(f"the {name} walks' digest {value} is not "
                             f"{WALK_DIGESTS[name]}")
    return value


def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    """``(bound ms, "bytes" or "operations")``: the larger of the bytes over
    HBM bandwidth and the operations over the peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


# the stream hold of device_time_ms: its timeout, and the most launches a
# chunk of timed calls may queue behind it (well inside CUDA's launch queue,
# so the host never blocks on a full queue while the stream is held)
HOLD_TIMEOUT_NS = 2_000_000_000
HOLD_BUDGET = 128


def stream_hold(flag: torch.Tensor, timed_out: torch.Tensor) -> None:
    """Enqueue ``csrc/stream_hold.cu`` on the current stream: it spins on
    the device until the host sets ``flag`` (one pinned host int32), or
    writes 1 to ``timed_out`` (a device int32) after HOLD_TIMEOUT_NS."""
    import ctypes

    from repro_torch.kernels import _launch

    _launch.launch("stream_hold", (_launch.P, _launch.P, ctypes.c_longlong,
                                   _launch.P),
                   flag.data_ptr(), timed_out.data_ptr(), HOLD_TIMEOUT_NS,
                   _launch.stream(timed_out.device))


def launches_per_call(fn) -> int:
    """The device activities (kernels, copies, fills) one ``fn(0)`` makes,
    from a ``torch.profiler`` trace."""
    prof = profile_window(lambda: fn(0), "")
    return max(1, sum(prof["device_launches_by_name"].values()))


def device_time_ms(fn, iters: int) -> tuple:
    """Device milliseconds per call of ``fn(i)``, i < iters, back to back on
    the card, with the host kept out.

    The calls are enqueued in chunks, each behind a stream hold
    (:func:`stream_hold`) that the host releases only after the chunk's
    last launch, between one pair of CUDA events: the chunk then runs back
    to back, and its events time device work only (each launch's own
    start-up on the card included, which CUPTI's kernel times leave out).
    A chunk queues at most ``HOLD_BUDGET`` launches (``launches_per_call``
    from a profiler trace of one call).  A call that alone makes more
    launches than that cannot be held: each is timed by its own events
    between synchronizations, host gaps included, and a line says so.
    Raises if a hold timed out (a timed call waited on the device).
    Returns ``(device ms per call, host enqueue ms per call, calls per
    held chunk (0: not held))``.
    """
    fn(0)
    torch.cuda.synchronize()
    per_call_launches = launches_per_call(fn)
    chunk = HOLD_BUDGET // (per_call_launches + 2)
    flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    timed_out = torch.zeros(1, dtype=torch.int32, device="cuda")
    enqueue_s, device_ms = 0.0, 0.0
    for lo in range(0, iters, max(chunk, 1)):
        hi = min(iters, lo + max(chunk, 1))
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        flag.zero_()
        torch.cuda.synchronize()
        if chunk:
            stream_hold(flag, timed_out)
        t = time.perf_counter()
        start.record()
        for i in range(lo, hi):
            fn(i)
        end.record()
        enqueue_s += time.perf_counter() - t
        flag.fill_(1)
        torch.cuda.synchronize()
        device_ms += start.elapsed_time(end)
    if int(timed_out.item()):
        raise AssertionError("device_time_ms: a stream hold timed out; a "
                             "timed call waited on the device")
    if not chunk:
        log(f"    (not held: {per_call_launches} launches a call exceed the "
            f"hold's {HOLD_BUDGET}; host gaps are in this time)")
    return device_ms / iters, enqueue_s * 1e3 / iters, chunk


def profile_window(fn, kernel_name: str, after: str = None) -> dict:
    """Device busy and idle share of ``fn()`` from a ``torch.profiler``
    trace, and the named kernel's device time per launch.

    The window runs from the first device activity to the last; idle is the
    part of it that no kernel, copy or fill covers.  With ``after``, the
    name of a CPU range (``"scan.capture"``: the capture of a walk loop,
    during which the card idles by design), only device activity that
    starts after that range ends counts: the replays of a captured loop.
    Returns all None when the profiler records no device activity there.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = prof.events()
    start = -float("inf")
    if after is not None:
        marks = [e.time_range.end for e in events if e.name == after]
        start = max(marks) if marks else float("inf")
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and e.time_range.start >= start]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    by_name: dict = {}
    count_by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
        count_by_name[e.name] = count_by_name.get(e.name, 0) + 1
    # the kernel's event name is its demangled signature
    mine = [e.time_range.end - e.time_range.start for e in dev_events
            if kernel_name in e.name]
    if not spans:
        return {"window_ms": None, "busy_ms": None, "idle_share": None,
                "kernel_ms": None, "kernel_launches": 0, "device_ms_by_name": {},
                "device_launches_by_name": {}}
    busy, cur_a, cur_b = 0.0, spans[0][0], spans[0][1]
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    window = spans[-1][1] - spans[0][0]
    return {"window_ms": window / 1e3, "busy_ms": busy / 1e3,
            "idle_share": 1.0 - busy / window,
            "kernel_ms": sum(mine) / len(mine) / 1e3 if mine else None,
            "kernel_launches": len(mine), "device_ms_by_name": by_name,
            "device_launches_by_name": count_by_name}


class ScanLog:
    """Keeps the ``ScanStats`` of every ``repro_torch.core.scan.scan`` call
    made inside it (the engine and the fleet look ``scan`` up at call
    time); with ``chunk``, every call's graphs hold ``chunk`` steps."""

    def __init__(self, chunk: int = None):
        self.chunk, self.stats = chunk, []

    def __enter__(self):
        from repro_torch.core import scan as scan_mod

        self._mod, self._scan = scan_mod, scan_mod.scan

        def recording(*args, **kw):
            if self.chunk is not None:
                kw["chunk"] = self.chunk
            out = self._scan(*args, **kw)
            self.stats.append(out[2])
            return out

        scan_mod.scan = recording
        return self

    def __exit__(self, *exc):
        self._mod.scan = self._scan


def scan_summary(stats, seconds: float) -> dict:
    """A captured call's graphs: K, replays, tail, capture seconds, the
    call's ms/step and the replayed ms/step (device, replays and tail)."""
    replay_ms = stats.replay_ms()
    return {"chunk": stats.chunk, "replays": stats.replays,
            "tail": stats.tail, "capture_s": stats.capture_s,
            "ms_per_step": seconds * 1e3 / stats.steps,
            "replayed_ms_per_step": (None if replay_ms is None
                                     else replay_ms / (stats.steps - 1))}


def fmt_loop(c: dict) -> str:
    return (f"captured {c['ms_per_step']:.5f} ms/step (replayed "
            f"{c['replayed_ms_per_step']:.5f}; K={c['chunk']} x "
            f"{c['replays']} replays + {c['tail']} tail, capture "
            f"{c['capture_s']:.4f} s), uncaptured "
            f"{c['uncaptured_ms_per_step']:.5f} ms/step; idle share captured "
            f"(replay window) {c['idle_share']}, uncaptured "
            f"{c['idle_share_uncaptured']}")


# steps of a profiled walk loop: the first, 12 replays of 8, no tail
PROFILE_STEPS = 97


def engine_loop(e, v0, steps: int, seed: int, dev, counters: dict,
                expect: dict, symbol: str, where: str) -> dict:
    """``e.run`` for ``steps`` steps from a generator seeded ``seed``: the
    default path (captured; every count set to 0 just before and held to
    ``expect`` just after) and the uncaptured loop, bit for bit equal
    (walks, hops, the (T,) overflow vector, the generator's final state);
    each one's ms/step, the graphs' K and capture time, and the idle share
    of a :data:`PROFILE_STEPS`-step window of each loop."""
    runs = {}
    for capture in (None, False):
        gen = torch.Generator(device=dev).manual_seed(seed)
        for c in counters.values():
            c.launches = 0
        with ScanLog() as sl:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nodes, hops, aux = e.run(v0, steps, generator=gen, with_aux=True,
                                     capture=capture)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        launches = {k: c.launches for k, c in counters.items()}
        if capture is None and launches != expect:
            raise AssertionError(f"{where} run launched {launches}, "
                                 f"expected {expect}")
        runs[capture] = {"nodes": nodes, "hops": hops,
                         "overflow": aux["compact_overflow"],
                         "state": gen.get_state(), "s": dt,
                         "stats": sl.stats[0]}
    c, u = runs[None], runs[False]
    for key in ("nodes", "hops", "overflow", "state"):
        if not torch.equal(c[key], u[key]):
            raise AssertionError(f"{where}: captured and uncaptured runs "
                                 f"differ in {key}")
    prof = {}
    for capture in (None, False):
        gen = torch.Generator(device=dev).manual_seed(seed)
        prof[capture] = profile_window(
            lambda: e.run(v0, PROFILE_STEPS, generator=gen, capture=capture),
            symbol, after="scan.capture" if capture is None else None)
    summary = scan_summary(c["stats"], c["s"])
    summary.update(uncaptured_ms_per_step=u["s"] * 1e3 / steps,
                   idle_share=prof[None]["idle_share"],
                   idle_share_uncaptured=prof[False]["idle_share"],
                   profile_kernel_ms=prof[None]["kernel_ms"],
                   launches=launches_of(expect),
                   launches_per_step=launches_of(expect) / steps)
    log(f"  {where}: {fmt_loop(summary)}; "
        f"{summary['launches_per_step']:g} kernel launches a step; captured "
        f"== uncaptured bit for bit (walks, hops, overflow, generator)")
    return {"nodes": c["nodes"], "hops": c["hops"], "overflow": c["overflow"],
            "loop": summary}


def launches_of(expect: dict) -> int:
    return sum(expect.values())


def launches_per_step(e) -> int:
    """Kernel launches a step of engine ``e`` makes: one, or one a degree
    bucket on the bucketed layout, two a bucket when compacted (the
    compacted passes and the full dispatch's, gated by the overflow)."""
    if e.layout != "bucketed":
        return 1
    b = len(e.bucket_neighbors)
    return 2 * b if (e.compact and b > 1) else b


def compare_with_plain(nxt_k, hops_k, nxt_p, hops_p, u, where: str) -> dict:
    """Hold the kernel's outputs against its plain version's: bitwise on
    every walk whose Lévy distance d rounds the same in both (a jumping
    walk whose hop count differs).  ``max_abs_err`` is taken over all
    walks and both outputs, before the bitwise check."""
    err = int(torch.maximum(
        (nxt_k.long() - nxt_p.long()).abs().max(),
        (hops_k.long() - hops_p.long()).abs().max(),
    ))
    d_diff = (u[:, 0] > 0.5) & (hops_k != hops_p)
    ok = ~d_diff
    bad = int((nxt_k[ok] != nxt_p[ok]).sum() + (hops_k[ok] != hops_p[ok]).sum())
    if bad:
        raise AssertionError(f"kernel disagrees with its plain version {where}: "
                             f"{bad} mismatches outside d differences")
    return {"walks": int(u.shape[0]), "jumps": int((u[:, 0] > 0.5).sum()),
            "d_differs": int(d_diff.sum()), "max_abs_err": err}


def bound_for_step(nodes, indptr, degrees, indices, edge_cdf, u, r, p_d,
                   max_degree):
    """``(bytes, ops)`` the fused step needs on these inputs.

    A walk whose flag is 0 reads its row pointer, degree, row total, the
    probes of the plain version's binary search and one neighbor id (the
    kernel's search reads more entries of the segment, a few sectors
    apart); a jumping walk reads degree, row pointer and neighbor id for
    each of its d hops.  Scattered loads count one 32-byte sector
    each, deduplicated per array; the node vector and the uniform block
    are read once and the two outputs written once.  Operations are a
    count of the scalar arithmetic per probe, per hop and per walk.
    """
    from repro_torch.core.engine import U_DIST, U_HOP0, U_JUMP, U_MH, search_iters
    from repro_torch.core.levy import trunc_geom_icdf

    w = nodes.numel()
    jump = u[:, U_JUMP] > 0.5
    v = nodes.long()
    sec = {"indptr": [], "degrees": [], "cdf": [], "indices": []}
    ops = 0
    # MH walks
    vm = v[~jump]
    start = indptr[vm].long()
    deg = degrees[vm].long()
    sec["indptr"].append(vm)
    sec["degrees"].append(vm)
    sec["cdf"].append(start + deg - 1)
    t = u[~jump, U_MH] * edge_cdf[start + deg - 1]
    lo, hi = torch.zeros_like(deg), deg.clone()
    for _ in range(search_iters(max_degree)):
        active = lo < hi
        mid = (lo + hi) // 2
        addr = start + torch.minimum(mid, deg - 1)
        sec["cdf"].append(addr[active])
        ops += 6 * int(active.sum())
        pred = active & (edge_cdf[addr] < t)
        lo = torch.where(pred, mid + 1, lo)
        hi = torch.where(active & ~pred, mid, hi)
    sec["indices"].append(start + torch.minimum(lo, deg - 1))
    ops += 8 * vm.numel()
    # jumping walks
    uj = u[jump]
    d = trunc_geom_icdf(uj[:, U_DIST], p_d, r).long()
    vc = v[jump]
    ops += 30 * vc.numel()  # log1p, divide, ceil, clamp
    for j in range(r):
        live = j < d
        vl = vc[live]
        dg = degrees[vl].long()
        ip = indptr[vl].long()
        sec["degrees"].append(vl)
        sec["indptr"].append(vl)
        hop = torch.minimum(
            (uj[live, U_HOP0 + j] * dg.float()).long(), dg - 1
        )
        sec["indices"].append(ip + hop)
        ops += 6 * vl.numel()
        vc = vc.clone()
        vc[live] = indices[ip + hop].long()
    nbytes = 0
    for addrs in sec.values():
        cat = torch.cat([a.reshape(-1) for a in addrs])
        nbytes += SECTOR * int(torch.unique(cat * 4 // SECTOR).numel())
    nbytes += w * 4 + u.numel() * 4 + 2 * w * 4
    return nbytes, ops


HOP_SLOPE_R = (1, 2, 4, 8, 16)


def events_and_cupti(fn, iters: int, symbol: str) -> dict:
    """Device ms per call of ``fn(i)``, i < iters, by CUDA events
    (:func:`device_time_ms`) and by CUPTI (:func:`profile_window` over the
    same calls, the mean of the events named ``symbol``)."""
    ms, host_ms, chunk = device_time_ms(fn, iters)
    prof = profile_window(lambda: [fn(i) for i in range(iters)], symbol)
    return {"events_ms": ms, "cupti_ms": prof["kernel_ms"],
            "cupti_launches": prof["kernel_launches"], "host_ms": host_ms,
            "held_chunk": chunk}


def fmt_ms(t: dict) -> str:
    cupti = "not measured" if t["cupti_ms"] is None else f"{t['cupti_ms']:.5f}"
    return f"{t['events_ms']:.5f} ms by events, {cupti} by CUPTI"


def chain_loads(u, p_d: float, r: int) -> int:
    """The longest dependent chain of loads the fused step forces on the
    block ``u``, whatever the design: an MH walk 4 (node; row pointer and
    degree; its CDF segment, read at once; the neighbor id), a jump of d
    hops 1 + 2d (node; then per hop degree and row pointer, then the
    neighbor id)."""
    from repro_torch.core.engine import U_DIST, U_JUMP
    from repro_torch.core.levy import trunc_geom_icdf

    jump = u[:, U_JUMP] > 0.5
    longest = 4 if bool((~jump).any()) else 0
    if bool(jump.any()):
        d = trunc_geom_icdf(u[jump, U_DIST], p_d, r)
        longest = max(longest, 1 + 2 * int(d.max()))
    return longest


def ragged_call(wt, nodes, kargs, u, p_d, r, max_degree):
    return wt.walk_transition_ragged(nodes, *kargs, u, p_d=p_d, r=r,
                                     max_degree=max_degree)


def hop_slope(wt, teng, kargs, n, p_d, max_degree, gen, dev, iters=200) -> dict:
    """The latency of one dependent scattered load on this graph: W=132
    walks from random nodes (a fresh draw per launch), every walk jumping
    with d forced to r (``u_dist`` the largest float32 below 1), timed at
    each r of :data:`HOP_SLOPE_R`.  A hop is two dependent loads (degree
    and row pointer, then the neighbor id), so the least-squares slope of
    ms against r, halved, is one load's latency."""
    w = 132
    below_one = float(np.nextafter(np.float32(1.0), np.float32(0.0)))
    per_r = {}
    for r in HOP_SLOPE_R:
        nodes = [torch.randint(0, n, (w,), generator=gen, device=dev,
                               dtype=torch.int32) for _ in range(iters)]
        blocks = []
        for _ in range(iters):
            u = torch.rand((w, teng.num_uniforms(r)), generator=gen, device=dev)
            u[:, teng.U_JUMP] = 1.0
            u[:, teng.U_DIST] = below_one
            blocks.append(u)
        _, hops = ragged_call(wt, nodes[0], kargs, blocks[0], p_d, r, max_degree)
        if not bool((hops == r).all()):
            raise AssertionError(f"hop slope: d is not forced to r={r}")
        per_r[r] = events_and_cupti(
            lambda i: ragged_call(wt, nodes[i], kargs, blocks[i], p_d, r,
                                  max_degree),
            iters, KERNEL_SYMBOL["walk_transition_ragged"])
    rs = np.array(HOP_SLOPE_R, dtype=np.float64)
    out = {"w": w, "per_r": {str(r): t for r, t in per_r.items()}}
    for how in ("events_ms", "cupti_ms"):
        ys = [per_r[r][how] for r in HOP_SLOPE_R]
        if None in ys:
            out[f"load_latency_{how}"] = None
            continue
        slope = float(np.polyfit(rs, np.array(ys), 1)[0])
        out[f"hop_slope_{how}"] = slope
        out[f"load_latency_{how}"] = slope / 2
    return out


def launch_floor(dev, iters: int = 200) -> dict:
    """One trivial launch, a one-element ``add_``, timed as the walk
    kernels are: by events behind a spin kernel and by CUPTI."""
    x = torch.zeros(1, device=dev)
    return events_and_cupti(lambda i: x.add_(1.0), iters, "elementwise")


def ragged_study(wt, teng, kargs, nodes, p_d, r, max_degree, gen, dev,
                 latency_ms, where: str) -> dict:
    """The ragged kernel on one node vector per launch (``nodes``, the
    main path's own): its time by events and by CUPTI at p_J = 0, 0.1 and
    1 (fresh blocks), the chain bound of each block set (:func:`chain_loads`
    times ``latency_ms``), and, at p_J = 0.1, the time of every lane-group
    width ``wt.RAGGED_GROUPS`` names, each held bitwise to the width the
    wrapper launches (skipped where the module has no such widths)."""
    iters = len(nodes)
    out: dict = {"iters": iters, "w": int(nodes[0].numel()), "p_j": {}}
    blocks_at = {}
    for p_j in (0.0, 0.1, 1.0):
        blocks = [teng.draw_uniforms(nodes[0].numel(), r, p_j, gen, dev)
                  for _ in range(iters)]
        blocks_at[p_j] = blocks
        t = events_and_cupti(
            lambda i: ragged_call(wt, nodes[i], kargs, blocks[i], p_d, r,
                                  max_degree),
            iters, KERNEL_SYMBOL["walk_transition_ragged"])
        chains = [chain_loads(u, p_d, r) for u in blocks]
        t["chain_loads_max"] = max(chains)
        t["chain_bound_ms"] = (None if latency_ms is None else
                               float(np.mean(chains)) * latency_ms)
        out["p_j"][str(p_j)] = t
        log(f"  ragged {where}, p_J={p_j}: {fmt_ms(t)}; longest chain "
            f"{t['chain_loads_max']} loads, chain bound "
            f"{t['chain_bound_ms']} ms")
    groups = getattr(wt, "RAGGED_GROUPS", None)
    if groups:
        main_group, blocks = wt.RAGGED_GROUP, blocks_at[0.1]
        want = ragged_call(wt, nodes[0], kargs, blocks[0], p_d, r, max_degree)
        out["groups"] = {}
        try:
            for g in groups:
                wt.RAGGED_GROUP = g
                got = ragged_call(wt, nodes[0], kargs, blocks[0], p_d, r,
                                  max_degree)
                if not (torch.equal(got[0], want[0])
                        and torch.equal(got[1], want[1])):
                    raise AssertionError(f"lane groups of {g} disagree with "
                                         f"{main_group} {where}")
                t = events_and_cupti(
                    lambda i: ragged_call(wt, nodes[i], kargs, blocks[i], p_d,
                                          r, max_degree),
                    iters, KERNEL_SYMBOL["walk_transition_ragged"])
                out["groups"][str(g)] = t
                log(f"  ragged {where}, p_J=0.1, {g} lanes a walk: {fmt_ms(t)}")
        finally:
            wt.RAGGED_GROUP = main_group
    return out


# Engine configurations of the padded and bucketed phase: the reference's
# benchmarks/large_graph_walk.py CONFIGS (:97-103), plus the ragged layout
# for the cross-layout check.
LAYOUT_CONFIGS = {
    "sparse": dict(layout="sparse"),
    "dense": dict(layout="dense"),
    "bucketed": dict(layout="bucketed", compact=False),
    "bucketed_compact": dict(layout="bucketed", compact=True),
    "bucketed_compact_f4": dict(layout="bucketed", compact=True,
                                bucket_factor=4),
    "ragged": dict(layout="ragged"),
}
KERNEL_OF_LAYOUT = {"sparse": "walk_transition_sparse",
                    "dense": "walk_transition", "bucketed": "walk_transition_sparse",
                    "ragged": "walk_transition_ragged"}
# each wrapper's CUDA kernel, as the profiler's event names contain it
KERNEL_SYMBOL = {"walk_transition_sparse": "walk_transition_sparse_kernel",
                 "walk_transition": "walk_transition_dense_kernel",
                 "walk_transition_ragged": "walk_transition_ragged_kernel"}


def sectors(addr_bytes: torch.Tensor) -> int:
    """Distinct 32-byte sectors among byte addresses."""
    return int(torch.unique(addr_bytes // SECTOR).numel()) if addr_bytes.numel() else 0


def bound_sparse(rows, u_mh) -> tuple:
    """``(bytes, ops, chain)`` the tile inversion needs on these inputs:
    every row entry once (the total needs them all), one neighbor-id sector
    per walk, the uniforms in and the picks out; operations: an add per
    nonzero entry for the total, and an add and a compare per nonzero entry
    up to the pick; ``chain``: the most nonzero entries in one row, the
    longest dependent add chain of the launch."""
    from repro_torch.core.engine import row_cdf

    w, width = rows.shape
    cdf = row_cdf(rows)
    idx = (cdf < (u_mh * cdf[:, -1])[:, None]).sum(dim=1).clamp(max=width - 1)
    nz = rows != 0
    cols = torch.arange(width, device=rows.device)
    upto = int((nz & (cols[None, :] <= idx[:, None])).sum())
    nbytes = w * width * 4 + w * SECTOR + w * 4 + w * 4
    ops = int(nz.sum()) + 2 * upto + w
    return nbytes, ops, int(nz.sum(dim=1).max()) if w else 0


def bound_dense(nodes, row_probs, neighbors, degrees, u, r, p_d) -> tuple:
    """``(bytes, ops, chain, hop_chain)`` the dense fused step needs on
    these inputs: an MH walk reads its degree, the first deg(v) entries of
    its row and one neighbor id; a jumping walk a degree and a neighbor id
    per hop.  Scattered reads count whole 32-byte sectors, deduplicated per
    table; the node vector and the uniforms are read once and both outputs
    written once.  ``chain``: the most nonzero entries among the entries an
    MH walk reads (its dependent adds); ``hop_chain``: the most dependent
    loads of a jumping walk (2 per hop)."""
    from repro_torch.core.engine import U_DIST, U_HOP0, U_JUMP, U_MH, row_cdf
    from repro_torch.core.levy import trunc_geom_icdf

    max_deg = neighbors.shape[1]
    jump = u[:, U_JUMP] > 0.5
    v = nodes.long()
    vm = v[~jump]
    deg = degrees[vm].long()
    start = vm * max_deg
    # row sectors: [start, start + deg) in float32 words
    rep = torch.repeat_interleave(torch.arange(vm.numel(), device=v.device), deg)
    offs = torch.arange(rep.numel(), device=v.device) - torch.repeat_interleave(
        torch.cumsum(deg, 0) - deg, deg)
    row_words = start[rep] + offs
    rows_m = row_probs[vm]
    cdf = row_cdf(rows_m)
    idx = (cdf < (u[~jump, U_MH] * cdf[:, -1])[:, None]).sum(dim=1)
    cols = torch.arange(max_deg, device=v.device)
    nz = (rows_m != 0) & (cols[None, :] < deg[:, None])
    chain = int(nz.sum(dim=1).max()) if vm.numel() else 0
    nbr_words = [start + torch.minimum(idx, deg - 1)]
    deg_words = [vm]
    ops = int(nz.sum()) + 2 * int((nz & (cols[None, :] <= idx[:, None])).sum())
    ops += vm.numel()
    uj = u[jump]
    d = trunc_geom_icdf(uj[:, U_DIST], p_d, r).long()
    hop_chain = 2 * int(d.max()) if d.numel() else 0
    vc = v[jump]
    ops += 30 * vc.numel()
    for j in range(r):
        live = j < d
        vl = vc[live]
        dg = degrees[vl].long()
        hop = torch.minimum((uj[live, U_HOP0 + j] * dg.float()).long(), dg - 1)
        deg_words.append(vl)
        nbr_words.append(vl * max_deg + hop)
        ops += 6 * vl.numel()
        vc = vc.clone()
        vc[live] = neighbors[vl, hop].long()
    nbytes = (sectors(row_words * 4) + sectors(torch.cat(nbr_words) * 4)
              + sectors(torch.cat(deg_words) * 4)) * SECTOR
    nbytes += nodes.numel() * 4 + u.numel() * 4 + 2 * nodes.numel() * 4
    return nbytes, ops, chain, hop_chain


def phase_layouts(dev, params) -> dict:
    """The padded and bucketed layouts on BA(100k,3) at W=2048: each
    kernel against its plain version on injected blocks, 200-step engine
    runs with launches, rates, overflow and a profiler window, the layouts
    against each other, and the two kernels' device times, bounds and
    longest chains (the sparse one at every bucket width too)."""
    from repro_torch.core import engine as teng
    from repro_torch.core.graphs import barabasi_albert
    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.kernels.walk_transition.ref import (
        walk_transition_ref,
        walk_transition_sparse_ref,
    )

    t0 = time.perf_counter()
    g = barabasi_albert(100_000, 3, seed=0, layout="csr")
    t_graph = time.perf_counter() - t0
    lips = np.exp(np.random.default_rng(11).normal(0.0, 1.0, g.n))
    t1 = time.perf_counter()
    engines = {
        name: teng.WalkEngine.from_graph(g, params, lipschitz=lips,
                                         device=dev, **kw)
        for name, kw in LAYOUT_CONFIGS.items()
    }
    torch.cuda.synchronize()
    t_engines = time.perf_counter() - t1
    hub = int(np.argmax(g.degrees))
    n_buckets = {k: len(e.bucket_neighbors) for k, e in engines.items()
                 if e.layout == "bucketed"}
    log(f"  graph BA(100k,3) csr: nnz={g.num_edges} max_deg={g.max_degree} "
        f"host build {t_graph:.2f} s; six engines (rows from Lipschitz on "
        f"the device) {t_engines:.2f} s; buckets {n_buckets}")
    sp, de = engines["sparse"], engines["dense"]
    err = {"walk_transition_sparse": 0, "walk_transition": 0}
    d_diff = 0
    gen = torch.Generator(device=dev)
    gen.manual_seed(4321)

    # (a) every kernel against its plain version on one injected block
    for w in (1, 257, 2048):
        for r in (1, 3, 5):
            nodes = torch.randint(0, g.n, (w,), generator=gen, device=dev,
                                  dtype=torch.int32)
            nodes[: w // 16 + 1] = hub
            u = teng.draw_uniforms(w, r, 0.5, gen, dev)
            u_mh = u[:, teng.U_MH].contiguous()
            tiles = [(sp.rows_for(nodes), sp.neighbors[nodes], u_mh)]
            for name in ("bucketed_compact", "bucketed_compact_f4"):
                e = engines[name]
                caps = e.bucket_capacities(w)
                plan = teng.compact_plan(e.node_bucket[nodes], len(caps))
                ins = e.compacted_bucket_inputs(nodes, u_mh, caps, *plan)
                tiles += list(zip(ins[2], ins[3], ins[4]))
            for rows_t, nbrs_t, u_t in tiles:
                vk = wt.walk_transition_sparse(rows_t, nbrs_t, u_t)
                vp = walk_transition_sparse_ref(rows_t, nbrs_t, u_t)
                e_abs = int((vk.long() - vp.long()).abs().max()) if w else 0
                err["walk_transition_sparse"] = max(
                    err["walk_transition_sparse"], e_abs)
                if not torch.equal(vk, vp):
                    raise AssertionError(
                        f"walk_transition_sparse disagrees with its plain "
                        f"version at W={w}, width {rows_t.shape[1]}")
            args = (nodes, de.row_probs, de.neighbors, de.degrees, u)
            nk, hk = wt.walk_transition(*args, p_d=params.p_d, r=r)
            np_, hp = walk_transition_ref(*args, p_d=params.p_d, r=r)
            c = compare_with_plain(nk, hk, np_, hp, u,
                                   f"(walk_transition) at W={w} r={r}")
            err["walk_transition"] = max(err["walk_transition"],
                                         c["max_abs_err"])
            d_diff += c["d_differs"]
    log(f"  kernels vs plain, one block at W in (1, 257, 2048) x r in "
        f"(1, 3, 5): walk_transition_sparse bitwise on the sparse tiles and "
        f"every compacted bucket tile (f2, f4); walk_transition bitwise "
        f"outside {d_diff} d differences; max abs err {err}")

    # (b) 200-step runs of every layout, launches counted per run
    counters = {"walk_transition_sparse": wt.walk_transition_sparse,
                "walk_transition": wt.walk_transition,
                "walk_transition_ragged": wt.walk_transition_ragged}
    w, steps = 2048, 200
    v0 = torch.as_tensor(
        np.random.default_rng(3).integers(0, g.n, w).astype(np.int32),
        device=dev,
    )
    runs = {}
    for name, e in engines.items():
        gen.manual_seed(99)
        e.run(v0, 5, generator=gen)  # warm
        torch.cuda.synchronize()
        mine = KERNEL_OF_LAYOUT[e.layout]
        expect = {k: (steps * launches_per_step(e) if k == mine else 0)
                  for k in counters}
        loop = engine_loop(e, v0, steps, 7, dev, counters, expect,
                           KERNEL_SYMBOL[mine], f"engine {name}")
        overflow = float(loop["overflow"].float().mean())
        runs[name] = {
            "launches": loop["loop"]["launches"],
            "run_ms": loop["loop"]["ms_per_step"] * steps,
            "ms_per_step": loop["loop"]["ms_per_step"],
            "walk_steps_per_s": w / (loop["loop"]["ms_per_step"] / 1e3),
            "overflow_rate": overflow, "loop": loop["loop"],
            "hops_mean": float(loop["hops"].double().mean()),
            "nodes": loop["nodes"], "hops": loop["hops"],
        }
        log(f"  engine {name}: {runs[name]['launches']} {mine} launches in "
            f"{steps} steps, {runs[name]['walk_steps_per_s']:.4e} "
            f"walk-steps/s captured, overflow rate {overflow:.4f}")

    # (c) the layouts against each other on the same injected blocks
    gen.manual_seed(7)
    blocks = [teng.draw_uniforms(w, params.r, params.p_j, gen, dev)
              for _ in range(steps)]
    base = runs["sparse"]
    cross_d = 0
    for t in range(0, steps, 10):
        cur = base["nodes"][:, t].contiguous()
        ref_n, ref_h = sp.step(cur, uniforms=blocks[t])
        for name, e in engines.items():
            nk, hk = e.step(cur, uniforms=blocks[t])
            c = compare_with_plain(nk, hk, ref_n, ref_h, blocks[t],
                                   f"({name} vs sparse) at block {t}")
            cross_d += c["d_differs"]
    traj_diff = {
        name: int((rr["nodes"] != base["nodes"]).sum())
        for name, rr in runs.items()
    }
    walks_digest = check_digest("sparse", digest(base["nodes"].cpu().numpy(),
                                                 base["hops"].cpu().numpy()))
    log(f"  layouts on the same 20 injected blocks: all six agree bitwise "
        f"outside {cross_d} d differences; 200-step trajectories differing "
        f"from sparse (walk-steps): {traj_diff}; sparse walks' digest "
        f"{walks_digest}")

    # device times, bounds and chains of the two kernels at the main path's
    # shapes
    cur = [base["nodes"][:, t].contiguous() for t in range(steps)]
    tiles = [(sp.rows_for(cur[t]), sp.neighbors[cur[t]],
              blocks[t][:, teng.U_MH].contiguous()) for t in range(50)]
    sp_t = events_and_cupti(lambda i: wt.walk_transition_sparse(*tiles[i]),
                            50, KERNEL_SYMBOL["walk_transition_sparse"])
    sp_plain = device_time_ms(
        lambda i: walk_transition_sparse_ref(*tiles[i]), 5)
    # the bounds average every fifth (sparse) or tenth (dense) launch's
    # inputs: their plain CDFs are a loop of ~1200 launches each; a chain
    # is the longest of those launches'
    b, o, c = zip(*(bound_sparse(rw, um) for rw, _, um in tiles[::5]))
    sp_bytes, sp_ops, sp_chain = sum(b) / len(b), sum(o) / len(o), max(c)
    del tiles
    dargs = (de.row_probs, de.neighbors, de.degrees)
    dcur = [runs["dense"]["nodes"][:, t].contiguous() for t in range(steps)]
    kw = dict(p_d=params.p_d, r=params.r)
    de_t = events_and_cupti(
        lambda i: wt.walk_transition(dcur[i], *dargs, blocks[i], **kw), steps,
        KERNEL_SYMBOL["walk_transition"])
    de_plain = device_time_ms(
        lambda i: walk_transition_ref(dcur[i], *dargs, blocks[i], **kw), 10)
    b, o, c, h = zip(*(bound_dense(dcur[t], *dargs, blocks[t], params.r,
                                   params.p_d) for t in range(0, steps, 10)))
    de_bytes, de_ops = sum(b) / len(b), sum(o) / len(o)
    de_chain, de_hops = max(c), max(h)

    # the sparse kernel at each bucket width: the bucketed engine's (W,
    # width_b) tiles, 9 launches a step, and the compacted engine's (cap_b,
    # width_b) tiles, the bucketed trainer's 4500 launches
    eb, ec = engines["bucketed"], engines["bucketed_compact"]
    caps = ec.bucket_capacities(w)
    per_width = {"full": [], "compact": []}
    for t in range(20):
        u_mh = blocks[t][:, teng.U_MH].contiguous()
        _, rows_b, tiles_b = eb._bucket_tiles(cur[t])
        per_width["full"].append(list(zip(rows_b, tiles_b, [u_mh] * len(rows_b))))
        plan = teng.compact_plan(ec.node_bucket[cur[t]], len(caps))
        ins = ec.compacted_bucket_inputs(cur[t], u_mh, caps, *plan)
        per_width["compact"].append(list(zip(ins[2], ins[3], ins[4])))
    by_width = {}
    for kind, steps_in in per_width.items():
        for bi in range(len(steps_in[0])):
            args = [step_in[bi] for step_in in steps_in]
            rows_t = args[0][0]
            call = lambda i, a=args: wt.walk_transition_sparse(*a[i])  # noqa: E731
            bb, oo, cc = zip(*(bound_sparse(rw, um) for rw, _, um in args[::5]))
            entry = {
                "walks": rows_t.shape[0], "width": rows_t.shape[1],
                "ms": device_time_ms(call, len(args))[0],
                "bound": bound(sum(bb) / len(bb), sum(oo) / len(oo),
                               FP32_OPS_PER_S),
                "chain": max(cc),
            }
            by_width[f"{kind} {rows_t.shape[1]}"] = entry
            log(f"  walk_transition_sparse {kind} bucket tiles ({entry['walks']}"
                f", {entry['width']}): {entry['ms']:.5f} ms/launch, bound "
                f"{entry['bound'][0]:.6f} ms by {entry['bound'][1]}, longest "
                f"chain {entry['chain']} adds")
    # what a compacted step's unused branch costs when the compacted one is
    # taken: the full dispatch's gathers, issued every step, and its tile
    # passes, launched gated off
    off = torch.zeros((), dtype=torch.bool, device=dev)
    dead = {
        "gathers_ms": device_time_ms(lambda i: ec._bucket_tiles(cur[i]),
                                     20)[0],
        "gated_passes_ms": device_time_ms(
            lambda i: [wt.walk_transition_sparse(rw, tl, um, off)
                       for rw, tl, um in per_width["full"][i]], 20)[0],
        "passes": len(per_width["full"][0]),
    }
    log(f"  bucketed_compact's unused full branch a step: gathers "
        f"{dead['gathers_ms']:.5f} ms, {dead['passes']} gated passes "
        f"{dead['gated_passes_ms']:.5f} ms (device, CUDA events)")
    del per_width

    timing = {
        "walk_transition_sparse": {
            "ms": sp_t["events_ms"], "host_ms": sp_t["host_ms"],
            "cupti_ms": sp_t["cupti_ms"], "held_chunk": sp_t["held_chunk"],
            "plain_ms": sp_plain[0], "bytes": sp_bytes, "ops": sp_ops,
            "bound": bound(sp_bytes, sp_ops, FP32_OPS_PER_S),
            "chain": sp_chain, "by_bucket_width": by_width,
            "unused_branch": dead,
        },
        "walk_transition": {
            "ms": de_t["events_ms"], "host_ms": de_t["host_ms"],
            "cupti_ms": de_t["cupti_ms"], "held_chunk": de_t["held_chunk"],
            "plain_ms": de_plain[0], "bytes": de_bytes, "ops": de_ops,
            "bound": bound(de_bytes, de_ops, FP32_OPS_PER_S),
            "chain": de_chain, "hop_chain": de_hops,
        },
    }
    for name, tm in timing.items():
        log(f"  {name}: {tm['ms']:.5f} ms/launch back to back on the device "
            f"(CUPTI {tm['cupti_ms']} ms; held in chunks of "
            f"{tm['held_chunk']}; host enqueue {tm['host_ms']:.5f} ms), plain "
            f"{tm['plain_ms']:.5f} ms, bound "
            f"{tm['bound'][0]:.6f} ms by {tm['bound'][1]} ({tm['bytes']:.0f} "
            f"B, {tm['ops']:.0f} ops per launch); longest chain "
            f"{tm['chain']} adds"
            + (f", {tm['hop_chain']} dependent hop loads"
               if "hop_chain" in tm else ""))
    for rr in runs.values():
        del rr["nodes"], rr["hops"]
    return {"graph_build_s": t_graph, "engines_build_s": t_engines,
            "buckets": n_buckets, "max_abs_err": err, "d_differs": d_diff,
            "runs": runs, "cross_layout_d_differs": cross_d,
            "trajectory_diff_vs_sparse": traj_diff,
            "walks_digest": walks_digest, "timing": timing,
            "graph": g}


def phase_layout_trainers(ttrain, g, data, gamma, params, dev,
                          ragged_nodes) -> dict:
    """``run_rw_sgd_multi("mhlj")`` on BA(100k,3) given as a ``CSRGraph``
    (sparse layout), as a ``BucketedCSRGraph`` (compacted) and as a
    ``CSRGraph`` with ``engine_kwargs={"layout": "dense"}``: launches per
    run, times, convergence, walks against the ragged run of the same
    seed, and every step's exact inputs replayed through kernel and plain
    version."""
    from repro_torch.core import engine as teng
    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.kernels.walk_transition.ref import (
        walk_transition_ref,
        walk_transition_sparse_ref,
    )

    steps, w = ragged_nodes.shape[1], ragged_nodes.shape[0]
    floor = data.mse(data.optimum())
    t0 = time.perf_counter()
    bg = g.to_bucketed()
    t_bucket = time.perf_counter() - t0
    cases = (("sparse", g, None, wt.walk_transition_sparse),
             ("bucketed_compact", bg, None, wt.walk_transition_sparse),
             ("dense", g, {"layout": "dense"}, wt.walk_transition))
    counters = (wt.walk_transition_sparse, wt.walk_transition,
                wt.walk_transition_ragged)
    out = {"bucketing_s": t_bucket}
    for name, graph, kw, kern in cases:
        for c in counters:
            c.launches = 0
        res, seen = timed_training(
            ttrain, "mhlj", graph, data, gamma, steps, w, mhlj_params=params,
            avg_every=50, seed=0, engine_kwargs=kw, device=dev,
        )
        launches = [c.launches for c in counters]
        eng = seen["fleet"].engine
        per_step = launches_per_step(eng)
        expect = [steps * per_step if c is kern else 0 for c in counters]
        if launches != expect:
            raise AssertionError(f"trainer ({name}) launched {launches}, "
                                 f"expected {expect}")
        loop = trainer_loop_check(ttrain, res, seen, f"trainer {name}")
        avg = res.avg_mse
        if not (np.isfinite(res.mse).all() and np.isfinite(avg).all()):
            raise AssertionError(f"trainer ({name}) produced non-finite MSE")
        if not (avg[-1] < avg[0] and avg[-1] <= 1.01 * floor):
            raise AssertionError(f"trainer ({name}) avg_mse {avg[0]} -> "
                                 f"{avg[-1]} does not reach the floor {floor}")
        diff = int((res.update_nodes != ragged_nodes).sum())
        # replay: the engine step must reproduce the run, and the kernel
        # must equal its plain version on every step's exact inputs (the
        # plain version runs on 25 steps' inputs at a time)
        g_rep = torch.Generator(device=dev)
        g_rep.set_state(seen["gen_state"])
        nodes = torch.as_tensor(res.update_nodes, device=dev)
        hops = torch.as_tensor(res.transitions, device=dev)
        pending, err, d_diff, overflow = [], 0, 0, 0

        def check_plain():
            nonlocal err, d_diff
            if not pending:
                return
            if kern is wt.walk_transition:
                cat = [torch.cat(x) for x in zip(*pending)]
                nk, hk, cur_c, u_c = cat
                np_, hp = walk_transition_ref(
                    cur_c, eng.row_probs, eng.neighbors, eng.degrees, u_c,
                    p_d=eng.p_d, r=eng.r)
                c = compare_with_plain(nk, hk, np_, hp, u_c,
                                       f"(trainer {name} replay)")
                err, d_diff = max(err, c["max_abs_err"]), d_diff + c["d_differs"]
            else:
                by_width: dict = {}
                for item in pending:
                    for rows_t, nbrs_t, u_t, vk in item:
                        by_width.setdefault(rows_t.shape[1], []).append(
                            (rows_t, nbrs_t, u_t, vk))
                for group in by_width.values():
                    rows_t, nbrs_t, u_t, vk = (torch.cat(x) for x in zip(*group))
                    vp = walk_transition_sparse_ref(rows_t, nbrs_t, u_t)
                    err = max(err, int((vk.long() - vp.long()).abs().max()))
                    if not torch.equal(vk, vp):
                        raise AssertionError(f"trainer ({name}) replay: "
                                             "kernel differs from plain")
            pending.clear()

        for t in range(steps):
            u = teng.draw_uniforms(w, eng.r, seen["p_j_sched"][t], g_rep, dev)
            cur = nodes[:, t].contiguous()
            nk, hk, aux = eng.step(cur, uniforms=u, with_aux=True)
            if not torch.equal(hk, hops[:, t]) or (
                t + 1 < steps and not torch.equal(nk, nodes[:, t + 1])
            ):
                raise AssertionError(f"replay of trainer ({name}) step {t} "
                                     "does not reproduce the run")
            overflow += int(aux["compact_overflow"])
            u_mh = u[:, teng.U_MH].contiguous()
            if kern is wt.walk_transition:
                pending.append((nk, hk, cur, u))
            elif eng.layout == "sparse":
                rows_t, nbrs_t = eng.rows_for(cur), eng.neighbors[cur]
                pending.append([(rows_t, nbrs_t, u_mh, wt.walk_transition_sparse(
                    rows_t, nbrs_t, u_mh))])
            else:
                if aux["compact_overflow"]:
                    _, rows_b, tiles_b = eng._bucket_tiles(cur)
                    us = [u_mh] * len(rows_b)
                else:
                    caps = eng.bucket_capacities(w)
                    plan = teng.compact_plan(eng.node_bucket[cur], len(caps))
                    ins = eng.compacted_bucket_inputs(cur, u_mh, caps, *plan)
                    rows_b, tiles_b, us = ins[2], ins[3], ins[4]
                pending.append([
                    (rb, tb, ub, wt.walk_transition_sparse(rb, tb, ub))
                    for rb, tb, ub in zip(rows_b, tiles_b, us)
                ])
            if len(pending) == 25:
                check_plain()
        check_plain()
        loop_ms = seen["loop_s"] / steps * 1e3
        out[name] = {
            "launches": launches, "train_s": seen["train_s"],
            "setup_s": seen["setup_s"], "loop_s": seen["loop_s"],
            "loop_ms_per_step": loop_ms, "avg_mse_first": float(avg[0]),
            "avg_mse_mid": float(avg[steps // 2]),
            "avg_mse_last": float(avg[-1]), "floor": float(floor),
            "walk_steps_differing_from_ragged": diff,
            "overflow_steps": overflow, "replay_max_abs_err": err,
            "replay_d_differs": d_diff,
            "hops_per_update": res.transitions_per_update, "loop": loop,
        }
        log(f"  trainer mhlj on {name} (W={w}, T={steps}): launches "
            f"{dict(zip(('sparse', 'dense', 'ragged'), launches))}, avg_mse "
            f"{avg[0]:.4f} -> {avg[steps // 2]:.4f} -> {avg[-1]:.4f} (floor "
            f"{floor:.4f}), {seen['train_s']:.2f} s (set-up "
            f"{seen['setup_s']:.2f} s, loop {loop_ms:.4f} ms/step), "
            f"{diff} walk-steps differ from the ragged run, overflow steps "
            f"{overflow}; replay: run reproduced, kernel == plain (max abs "
            f"err {err}, {d_diff} d differences)")
    return out


def timed_training(ttrain, method, graph, data, gamma, steps, *walks,
                   entry="run_rw_sgd_multi", capture=None, **kw):
    """``ttrain.<entry>`` (``run_rw_sgd_multi``, or ``run_rw_sgd`` with no
    ``walks``) with its set-up and its training loop timed apart, and the
    loop's arguments, fleet, p_J schedule, generator starting state and
    ``ScanStats`` kept, so every step's kernel inputs can be replayed and
    the loop run again.  The trainer runs unchanged: only ``run_fleet`` is
    wrapped (``capture=False`` runs its loop uncaptured)."""
    seen: dict = {}
    run_fleet = ttrain.run_fleet

    def timed_run_fleet(*args, **fkw):
        torch.cuda.synchronize()
        seen["enter"] = time.perf_counter()
        seen["args"], seen["kwargs"] = args, dict(fkw)
        seen["fleet"], seen["p_j_sched"] = args[4], args[7]
        gen = fkw.get("generator")
        seen["gen_state"] = None if gen is None else gen.get_state()
        with ScanLog() as sl:
            out = run_fleet(*args, **fkw, capture=capture)
            torch.cuda.synchronize()
        seen["loop_s"] = time.perf_counter() - seen["enter"]
        seen["scan"] = sl.stats[0]
        return out

    ttrain.run_fleet = timed_run_fleet
    try:
        t0 = time.perf_counter()
        res = getattr(ttrain, entry)(method, graph, data, gamma, steps,
                                     *walks, **kw)
        seen["train_s"] = time.perf_counter() - t0
    finally:
        ttrain.run_fleet = run_fleet
    seen["setup_s"] = seen.pop("enter") - t0
    return res, seen


def fleet_loop_again(ttrain, seen, num_steps=None, capture=False):
    """The loop ``timed_training`` saw, run again from the generator's
    starting state (``num_steps`` of it, default all; ``capture=False``
    uncaptured); returns ``run_fleet``'s outputs and its seconds."""
    args = list(seen["args"])
    if num_steps is not None:
        args[5], args[7] = num_steps, args[7][:num_steps]
    kw = dict(seen["kwargs"], capture=capture)
    if seen["gen_state"] is not None:
        gen = torch.Generator(device=args[0].device)
        gen.set_state(seen["gen_state"])
        kw["generator"] = gen
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = ttrain.run_fleet(*args, **kw)
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def trainer_loop_check(ttrain, res, seen, where: str) -> dict:
    """The captured training loop against the same loop uncaptured, from
    the same generator state: update nodes, hops, both MSE traces and the
    final models bit for bit; ms/step of each, K and the capture time, and
    the idle share of a :data:`PROFILE_STEPS`-step window of each loop."""
    (xs, mse, avg, nodes, hops, _), dt = fleet_loop_again(ttrain, seen)
    got = {"update_nodes": nodes, "transitions": hops, "mse": mse,
           "avg_mse": avg, "x_final": xs}
    for name, t in got.items():
        want = getattr(res, name)
        if not np.array_equal(t.cpu().numpy(), want):
            raise AssertionError(f"{where}: captured and uncaptured loops "
                                 f"differ in {name}")
    steps = seen["scan"].steps
    summary = scan_summary(seen["scan"], seen["loop_s"])
    summary["uncaptured_ms_per_step"] = dt * 1e3 / steps
    for capture, key in ((None, "idle_share"),
                         (False, "idle_share_uncaptured")):
        prof = profile_window(
            lambda: fleet_loop_again(ttrain, seen, PROFILE_STEPS, capture),
            "walk_transition",
            after="scan.capture" if capture is None else None)
        summary[key] = prof["idle_share"]
    log(f"  {where} loop: {fmt_loop(summary)}; "
        "captured == uncaptured bit for bit (walks, hops, MSE traces, "
        "models)")
    return summary


# -- the LLM slice: phases 6-8 ---------------------------------------------------

# tests/test_kernels.py's tolerances (atol = rtol), float32 / bfloat16
LLM_TOL = {"flash_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2},
           "ssd_scan": {torch.float32: 2e-4, torch.bfloat16: 6e-2},
           "rmsnorm_fused": {torch.float32: 1e-5, torch.bfloat16: 3e-2}}
# prefill at full width, final hidden states: the kernel path against the
# einsum path in float32 on the same weights (tests/test_perf_paths.py's
# 2e-4), and in bf16 the kernel path's distance to the float32 einsum run
# against the einsum path's.  The bf16 paths are not held to each other:
# the random-init bf16 stack carries float32-sized differences up to the
# bf16 noise floor (measured in phase 7 on mamba2-370m).
PREFILL_F32_REL_ERR = 2e-4
PREFILL_BF16_RATIO = 1.25


def sass_count(library: str, opcode: str) -> int:
    """How many instructions of ``opcode`` ``cuobjdump -sass`` finds in the
    built ``library``."""
    from pathlib import Path

    from repro_torch.kernels import _build

    tool = Path(_build._nvcc()).parent / "cuobjdump"
    sass = subprocess.run([str(tool), "-sass", str(_build._target(library))],
                          capture_output=True, text=True, check=True,
                          timeout=120).stdout
    return sum(opcode in line for line in sass.splitlines())


def hold(name: str, got: torch.Tensor, want: torch.Tensor, dtype,
         where: str) -> float:
    """Max abs error of ``got`` against ``want`` (in float32); raise if any
    element is beyond the kernel's tolerance for inputs of ``dtype``."""
    tol = LLM_TOL[name][dtype]
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    bad = int(((g - w).abs() > tol + tol * w.abs()).sum())
    if bad or not torch.isfinite(g).all():
        raise AssertionError(f"{name} disagrees with its plain version {where}: "
                             f"{bad} elements beyond {tol}, max abs err {err}")
    log(f"  {name} vs plain {where}: max abs err {err:.3e} (tol {tol})")
    return err


def flash_bound(b, s, t, n, kh, h, elt, causal, window) -> tuple:
    """``(bytes, ops)`` of one attention call: q, k, v read once and the
    output written once; 4h flops (q.k and p.v) per live (row, col) pair."""
    rows = torch.arange(s, dtype=torch.float64)
    if causal:
        lo = (rows - window + 1).clamp(min=0) if window > 0 else torch.zeros(s, dtype=torch.float64)
        live = float(((rows.clamp(max=t - 1) + 1) - lo).clamp(min=0).sum())
    else:
        live = float(s) * t
    nbytes = (2 * b * s * n * h + 2 * b * t * kh * h) * elt
    return nbytes, 4.0 * h * live * b * n


def ssd_bound(b, h, l, p, n, q, elt) -> tuple:
    """``(bytes, ops)`` of one SSD scan: x, B, C (as passed, group-expanded)
    and the float32 da, dt read once, y (float32) written once; per chunk
    the lower-triangular C.B^T and att @ x, the state term and the state
    update."""
    nbytes = b * h * l * ((p + 2 * n) * elt + 2 * 4 + p * 4)
    pairs = q * (q + 1) / 2
    per_chunk = pairs * 2 * (n + p) + 2 * (2 * q * n * p)
    return nbytes, per_chunk * (l // q) * b * h


def phase_flash(model, cfg, dev, gen) -> dict:
    """``flash_attention`` against its plain version: the bf16 route
    (``wgmma_bf16``) on minitron-8b's layer 0 q/k/v (B=1, S=4096, N=32,
    K=8, h=128, causal), at S=4000 (the tail mask) and at h=64; the float32
    route (``cuda_core_f32``) on a small shape.  Device times of both
    routes at minitron's shape (float32: the same q/k/v upcast), achieved
    TFLOP/s and share of the bound, the plain version's time and SDPA's
    (a yardstick only: the port never calls it)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models.layers import attention as attn_mod
    from repro_torch.models.layers.norms import rmsnorm

    s = 4096
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=dev)
    lp = model.layers[0]
    with torch.no_grad():
        x = rmsnorm(lp["ln1"], model.embedding["table"][tokens], cfg.norm_eps)
        q, k, v = attn_mod._project_qkv(
            lp["attn"], x, model.dims, torch.arange(s, device=dev).expand(1, s))
    q, k, v = (t.contiguous() for t in (q, k, v))
    bf16, f32 = torch.bfloat16, torch.float32
    before = dict(fa_ops.mha.launches_by_route)
    errs = {"wgmma_bf16": [hold("flash_attention", fa_ops.mha(q, k, v, causal=True),
                                mha_ref(q, k, v, causal=True), bf16,
                                "at B=1 S=4096 N=32 K=8 h=128 bf16")]}
    q4, k4, v4 = (t[:, :4000].contiguous() for t in (q, k, v))
    errs["wgmma_bf16"].append(hold(
        "flash_attention", fa_ops.mha(q4, k4, v4, causal=True),
        mha_ref(q4, k4, v4, causal=True), bf16, "at S=4000 (tail mask) bf16"))
    q6, k6, v6 = (torch.randn((1, 2048, nh, 64), generator=gen, device=dev).to(bf16)
                  for nh in (16, 4, 4))
    errs["wgmma_bf16"].append(hold(
        "flash_attention", fa_ops.mha(q6, k6, v6, causal=True),
        mha_ref(q6, k6, v6, causal=True), bf16, "at B=1 S=2048 N=16 K=4 h=64 bf16"))
    qf, kf, vf = (torch.randn((1, 1000, nh, 128), generator=gen, device=dev)
                  for nh in (8, 2, 2))
    errs["cuda_core_f32"] = [hold("flash_attention", fa_ops.mha(qf, kf, vf, causal=True),
                                  mha_ref(qf, kf, vf, causal=True), f32,
                                  "at B=1 S=1000 N=8 K=2 float32")]
    went = {r: fa_ops.mha.launches_by_route[r] - before[r] for r in before}
    if went != {"wgmma_bf16": 3, "cuda_core_f32": 1}:
        raise AssertionError(f"flash_attention took the routes {went}")
    nbytes, ops = flash_bound(1, s, s, cfg.num_heads, cfg.num_kv_heads, 128, 2,
                              True, 0)
    routes = {}
    for route, dtype, peak in (("wgmma_bf16", bf16, BF16_OPS_PER_S),
                               ("cuda_core_f32", f32, FP32_OPS_PER_S)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        ms = device_time_ms(lambda i: fa_ops.mha(qd, kd, vd, causal=True),
                            20 if dtype == bf16 else 3)
        plain = device_time_ms(lambda i: mha_ref(qd, kd, vd, causal=True), 3)
        qt, kt, vt = (t.transpose(1, 2) for t in (qd, kd, vd))
        lib = device_time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True), 10)
        b_ms, b_by = bound(nbytes * dtype.itemsize / 2, ops, peak)
        routes[route] = {"ms": ms[0], "plain_ms": plain[0], "library_ms": lib[0],
                         "bound_ms": b_ms, "bound_by": b_by,
                         "tflops": ops / ms[0] / 1e9,
                         "bound_share": b_ms / ms[0],
                         "max_abs_err": max(errs[route])}
        log(f"  flash_attention {route}: {ms[0]:.4f} ms/launch on the device "
            f"({ops / ms[0] / 1e9:.1f} TFLOP/s, {b_ms / ms[0]:.1%} of its bound "
            f"{b_ms:.5f} ms by {b_by}), plain {plain[0]:.4f} ms, SDPA "
            f"{lib[0]:.4f} ms ({ms[0] / lib[0]:.2f}x SDPA) "
            f"({nbytes * dtype.itemsize / 2:.4e} B, {ops:.4e} flop)")
    main = routes["wgmma_bf16"]
    return {**main, "max_abs_err": max(max(e) for e in errs.values()),
            "bytes": nbytes, "ops": ops, "routes": routes}


def ssd_mma_bytes(b, h, l, p, n, q) -> float:
    """Bytes the three passes of ``csrc/ssd_scan_mma.cu`` move, each tensor
    once per pass that touches it: pass 1 reads B, x, da and dt and writes
    every chunk's (N, P) float32 state and decay; pass 2 reads and writes
    the states; pass 3 reads C, B, x, da, dt and the states and writes y."""
    rows, chunks = b * h * l, b * h * (l // q)
    states = chunks * n * p * 4
    pass1 = rows * ((n + p) * 2 + 8) + states + chunks * 4
    pass2 = 2 * states + chunks * 4
    pass3 = rows * ((2 * n + p) * 2 + 8 + p * 4) + states
    return pass1 + pass2 + pass3


def phase_ssd(model, cfg, dev, gen) -> dict:
    """``ssd_scan`` on mamba2-370m's layer 0 (B=4, L=4096, H=32, P=64,
    N=128, chunk 256): the bf16 route (``mma_bf16``) against its plain
    version there and at L=4000 through ``ops.ssd``'s padding, and the
    float32 route (``cuda_core_f32``) on the same inputs upcast; both
    routes, at both lengths, held to the float64 result too (no more than
    twice the plain version's error), each error logged beside the plain
    version's and max |y|.  Device times of both routes with the share of the bound,
    the bytes the bf16 route's design moves, and ``ops._head_major``'s
    copies timed apart."""
    import torch.nn.functional as F

    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.models.layers import mamba2 as mamba_mod
    from repro_torch.models.layers.norms import rmsnorm

    b, l = 4, 4096
    tokens = torch.randint(0, cfg.vocab_size, (b, l), generator=gen, device=dev)
    lp, dims = model.layers[0], model.mdims
    with torch.no_grad():
        x = rmsnorm(lp["ln"], model.embedding["table"][tokens], cfg.norm_eps)
        _, conv_in, dt_raw = mamba_mod._split_proj(lp["mixer"], x, dims)
        conv = F.silu(mamba_mod._causal_conv(conv_in, lp["mixer"]["conv_w"],
                                             lp["mixer"]["conv_b"]))
        xs, bs, cs = mamba_mod._split_conv_out(conv, dims)
        dt = F.softplus(dt_raw.float() + lp["mixer"]["dt_bias"])
        a = -torch.exp(lp["mixer"]["a_log"])
    args = ssd_ops._head_major(xs, dt, a, bs, cs)
    args32 = tuple(t.float() for t in args)
    chunk = dims.chunk
    h, p, n = dims.num_heads, dims.head_dim, dims.d_state
    bf16, f32 = torch.bfloat16, torch.float32
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    plain_y = ssd_scan_ref(*args, chunk=chunk)
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    errs = {"mma_bf16": [hold("ssd_scan", y, plain_y, bf16,
                              "at B=4 L=4096 H=32 P=64 N=128 chunk 256 bf16")]}
    y4, _ = ssd_ops.ssd(xs[:, :4000], dt[:, :4000], a, bs[:, :4000], cs[:, :4000],
                        chunk=chunk)
    # y is causal in L: rows < 4000 of the L=4096 plain run are the answer
    errs["mma_bf16"].append(hold("ssd_scan", y4, plain_y[:, :, :4000].transpose(1, 2),
                                 bf16, "at L=4000 through ops.ssd (padded to 4096)"))
    y32 = ssd_ops.ssd_scan(*args32, chunk=chunk)
    went = {r: ssd_ops.ssd_scan.launches_by_route[r] - before[r] for r in before}
    if went != {"mma_bf16": 2, "cuda_core_f32": 1}:
        raise AssertionError(f"ssd_scan took the routes {went}")
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    top = float(exact.abs().max())
    err64 = {name: float((t.double() - exact).abs().max())
             for name, t in (("mma_bf16", y), ("cuda_core_f32", y32),
                             ("plain", plain_y))}
    # rows < 4000 of the L=4000 run through ops.ssd, and the plain version's
    # error on the same rows
    rows = exact[:, :, :4000].transpose(1, 2)
    err64["mma_bf16_l4000"] = float((y4.double() - rows).abs().max())
    err64["plain_l4000"] = float((plain_y[:, :, :4000].transpose(1, 2).double()
                                  - rows).abs().max())
    del exact, rows
    # the outputs here are small (max |y| is logged): the bf16 tolerance alone
    # would pass a kernel that writes zeros, so both routes are held to the
    # float64 result, no worse than twice the plain version's error (the
    # card test's rule for float32 at N=128, chunk 256)
    for route, ref_key in (("mma_bf16", "plain"), ("mma_bf16_l4000", "plain_l4000"),
                           ("cuda_core_f32", "plain")):
        if not err64[route] <= 2 * err64[ref_key]:
            raise AssertionError(f"ssd_scan {route} against float64: {err64}")
    errs["cuda_core_f32"] = [float((y32 - plain_y).abs().max())]
    log(f"  ssd_scan max abs err against the float64 result (max |y| "
        f"{top:.3e}): mma_bf16 {err64['mma_bf16']:.3e} (L=4000 through ops.ssd "
        f"{err64['mma_bf16_l4000']:.3e}), cuda_core_f32 (inputs upcast) "
        f"{err64['cuda_core_f32']:.3e}, plain version {err64['plain']:.3e} "
        f"(rows < 4000: {err64['plain_l4000']:.3e})")
    plain = device_time_ms(lambda i: ssd_scan_ref(*args, chunk=chunk), 3)
    head_major = device_time_ms(lambda i: ssd_ops._head_major(xs, dt, a, bs, cs), 10)
    log(f"  ops._head_major (layout change, group repeat of B and C): "
        f"{head_major[0]:.4f} ms on the device")
    nbytes, ops = ssd_bound(b, h, l, p, n, chunk, 2)
    design = ssd_mma_bytes(b, h, l, p, n, chunk)
    routes = {}
    for route, t, peak, iters in (("mma_bf16", args, BF16_OPS_PER_S, 20),
                                  ("cuda_core_f32", args32, FP32_OPS_PER_S, 3)):
        ms = device_time_ms(lambda i: ssd_ops.ssd_scan(*t, chunk=chunk), iters)
        rb = ssd_bound(b, h, l, p, n, chunk, t[0].element_size())[0]
        b_ms, b_by = bound(rb, ops, peak)
        routes[route] = {"ms": ms[0], "plain_ms": plain[0], "library_ms": None,
                         "bound_ms": b_ms, "bound_by": b_by, "bytes": rb,
                         "bound_share": b_ms / ms[0], "max_abs_err": max(errs[route]),
                         "max_abs_err_vs_f64": err64[route]}
        log(f"  ssd_scan {route}: {ms[0]:.4f} ms/launch on the device "
            f"({b_ms / ms[0]:.1%} of its bound {b_ms:.5f} ms by {b_by}; "
            f"{rb:.4e} B, {ops:.4e} flop), plain {plain[0]:.4f} ms")
    main = routes["mma_bf16"]
    log(f"  ssd_scan mma_bf16 design moves {design:.4e} B "
        f"({design / HBM_BYTES_PER_S * 1e3:.5f} ms at the HBM rate, "
        f"{design / HBM_BYTES_PER_S * 1e3 / main['ms']:.1%} of the measured time)")
    # the bf16 route's three launches apart, by CUPTI over 20 calls; each
    # kernel's time over the launches the trace recorded (a short trace
    # can miss the first)
    prof = profile_window(lambda: [ssd_ops.ssd_scan(*args, chunk=chunk)
                                   for _ in range(20)], "ssd_chunk_out_kernel")
    passes = {}
    for name in ("ssd_chunk_state_kernel", "ssd_state_pass_kernel",
                 "ssd_chunk_out_kernel"):
        keys = [k for k in prof["device_ms_by_name"] if name in k]
        passes[name] = (sum(prof["device_ms_by_name"][k] for k in keys)
                        / max(1, sum(prof["device_launches_by_name"][k] for k in keys)))
    log(f"  ssd_scan mma_bf16 passes (CUPTI, ms/launch): "
        + ", ".join(f"{k} {v:.4f}" for k, v in passes.items())
        + f"; idle share {prof['idle_share']}")
    return {**main, "max_abs_err": max(errs["mma_bf16"]), "bytes": nbytes,
            "ops": ops, "design_bytes": design, "head_major_ms": head_major[0],
            "passes_ms": passes, "max_abs_err_vs_f64": err64, "max_abs_y": top,
            "routes": routes}


def phase_rmsnorm(dev, gen) -> dict:
    """``rmsnorm_fused`` against its plain version at (4096, 4096) and
    (16384, 1024) in bf16 and float32; device times of each, the kernel
    that ran, share of the bound and ``F.rms_norm``; the JSON line carries
    minitron's (4096, 4096) bf16."""
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref

    out, errs = {}, []
    for rows, d in ((4096, 4096), (16384, 1024)):
        for dtype in (torch.bfloat16, torch.float32):
            x = torch.randn((rows, d), generator=gen, device=dev).to(dtype)
            scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
            before = dict(rms_ops.rmsnorm_fused.launches_by_kernel)
            errs.append(hold("rmsnorm_fused", rms_ops.rmsnorm(x, scale),
                             rmsnorm_ref(x, scale), dtype,
                             f"at ({rows}, {d}) {dtype}"))
            kernel = [k for k, n in rms_ops.rmsnorm_fused.launches_by_kernel.items()
                      if n != before[k]]
            ms = device_time_ms(lambda i: rms_ops.rmsnorm(x, scale), 20)
            plain = device_time_ms(lambda i: rmsnorm_ref(x, scale), 10)
            w = scale.to(dtype)
            lib = device_time_ms(lambda i: torch.nn.functional.rms_norm(
                x, (d,), weight=w, eps=1e-6), 20)
            nbytes = 2 * rows * d * x.element_size() + d * 4
            b_ms, b_by = bound(nbytes, 4.0 * rows * d, FP32_OPS_PER_S)
            key = f"{rows}x{d}_{str(dtype).split('.')[-1]}"
            out[key] = {"ms": ms[0], "plain_ms": plain[0], "library_ms": lib[0],
                        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                        "kernel": kernel, "bound_share": b_ms / ms[0]}
            log(f"  rmsnorm_fused {key} ({'/'.join(kernel)} kernel): {ms[0]:.5f} "
                f"ms/launch on the device ({b_ms / ms[0]:.1%} of its bound "
                f"{b_ms:.5f} ms by {b_by}), plain {plain[0]:.5f} ms, F.rms_norm "
                f"{lib[0]:.5f} ms (kernel / F.rms_norm {ms[0] / lib[0]:.3f})")
    return {"max_abs_err": max(errs), "shapes": out, **out["4096x4096_bfloat16"]}


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative Frobenius error of ``a`` against ``b``, in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def both_paths(model, cfg, tokens) -> dict:
    """``apply`` with ``use_kernels=True`` (launches counted from 0; one
    kernel per layer and nothing else, or raise) and with the einsum path
    on the same weights, each timed with its peak memory."""
    import dataclasses

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    counters = {"flash_attention": fa_ops.mha, "ssd_scan": ssd_ops.ssd_scan,
                "rmsnorm_fused": rms_ops.rmsnorm_fused}
    expect = {"flash_attention": cfg.num_layers if cfg.family == "dense" else 0,
              "ssd_scan": cfg.num_layers if cfg.family == "ssm" else 0,
              "rmsnorm_fused": 0}
    # the flash and SSD routes the model's dtype (and SSD shape) take, once
    # per layer
    dtype = model.embedding["table"].dtype
    route = fa_ops.route_of(dtype)
    expect_routes = {r: expect["flash_attention"] if r == route else 0
                     for r in fa_ops.mha.launches_by_route}
    expect_ssd = dict.fromkeys(ssd_ops.ROUTES, 0)
    if cfg.family == "ssm":
        d = model.mdims
        expect_ssd[ssd_ops.route_of(dtype, d.head_dim, d.d_state, d.chunk)] = (
            cfg.num_layers)
    out = {}
    for path, use_kernels in (("kernel", True), ("einsum", False)):
        model.cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        fa_ops.mha.launches_by_route = dict.fromkeys(expect_routes, 0)
        ssd_ops.ssd_scan.launches_by_route = dict.fromkeys(expect_ssd, 0)
        t0 = time.perf_counter()
        h = model.apply({"tokens": tokens})
        torch.cuda.synchronize()
        out[path] = {"h": h, "s": time.perf_counter() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "launches": {k: c.launches for k, c in counters.items()},
                     "routes": dict(fa_ops.mha.launches_by_route),
                     "ssd_routes": dict(ssd_ops.ssd_scan.launches_by_route)}
        if not torch.isfinite(h).all() or tuple(h.shape) != (
                *tokens.shape, cfg.d_model):
            raise AssertionError(f"{cfg.name} {path} path: shape "
                                 f"{tuple(h.shape)} or non-finite values")
    model.cfg = cfg
    k = out["kernel"]
    if (k["launches"] != expect or k["routes"] != expect_routes
            or k["ssd_routes"] != expect_ssd):
        raise AssertionError(f"{cfg.name} prefill launched {k['launches']}, "
                             f"flash routes {k['routes']}, SSD routes "
                             f"{k['ssd_routes']}, expected {expect}, "
                             f"{expect_routes}, {expect_ssd}")
    return out


def prefill(model, cfg, batch, seq, dev, gen) -> dict:
    """Prefill (``apply``) at full width in bf16 on both paths (after a
    warm call), ``ops.rmsnorm`` on the kernel path's output (launches
    counted from 0), and — for the SSM — the einsum path again with its SSD
    output perturbed by float32 noise of relative size 1e-6 (how far the
    bf16 stack carries noise at float32's scale)."""
    import dataclasses

    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.models.layers import mamba2 as mamba_mod
    from repro_torch.models.layers.norms import rmsnorm

    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=dev)
    model.cfg = dataclasses.replace(cfg, use_kernels=True)
    model.apply({"tokens": tokens})  # warm: cuBLAS and the kernels' libraries
    runs = both_paths(model, cfg, tokens)
    h_k, h_e = runs["kernel"]["h"], runs["einsum"]["h"]
    rel = rel_err(h_k, h_e)
    floor = None
    if cfg.family == "ssm":
        chunked, noise = mamba_mod.ssd_chunked, torch.Generator(device=dev)
        noise.manual_seed(1)

        def perturbed(*args, **kw):
            y, h = chunked(*args, **kw)
            return y * (1 + 1e-6 * torch.randn(y.shape, generator=noise,
                                               device=y.device)), h

        mamba_mod.ssd_chunked = perturbed
        try:
            floor = rel_err(model.apply({"tokens": tokens}), h_e)
        finally:
            mamba_mod.ssd_chunked = chunked
    rms_ops.rmsnorm_fused.launches = 0
    normed = rms_ops.rmsnorm(h_k, model.ln_f["scale"], cfg.norm_eps)
    rms_launches = rms_ops.rmsnorm_fused.launches
    rms_err = hold("rmsnorm_fused", normed, rmsnorm(model.ln_f, h_k, cfg.norm_eps),
                   h_k.dtype, f"through ops.rmsnorm on {cfg.name}'s prefill output")
    tok = batch * seq
    k, e = runs["kernel"], runs["einsum"]
    log(f"  prefill {cfg.name} B={batch} S={seq} bf16: kernel path {k['s']:.4f} s "
        f"({tok / k['s']:.1f} tokens/s, peak {k['peak_bytes'] / 2**30:.3f} GiB), "
        f"einsum path {e['s']:.4f} s ({tok / e['s']:.1f} tokens/s, peak "
        f"{e['peak_bytes'] / 2**30:.3f} GiB), relative Frobenius error kernel vs "
        f"einsum {rel:.4e}, einsum vs einsum with 1e-6 noise in the SSD output "
        f"{floor}, launches {k['launches']}, flash routes {k['routes']}, "
        f"SSD routes {k['ssd_routes']}, ops.rmsnorm launches {rms_launches}")
    return {"batch": batch, "seq": seq, "tokens": tokens, "h_kernel": h_k,
            "h_einsum": h_e, "kernel_s": k["s"], "einsum_s": e["s"],
            "tokens_per_s": tok / k["s"], "einsum_tokens_per_s": tok / e["s"],
            "peak_bytes": k["peak_bytes"], "einsum_peak_bytes": e["peak_bytes"],
            "rel_kernel_vs_einsum_bf16": rel, "rel_noise_floor_bf16": floor,
            "launches": k["launches"], "routes": k["routes"],
            "ssd_routes": k["ssd_routes"], "rmsnorm_launches": rms_launches,
            "rmsnorm_max_abs_err": rms_err}


def prefill_accuracy(model, cfg, pre: dict) -> dict:
    """The same weights upcast to float32 (in place; the model is not used
    in bf16 again): the kernel path against the einsum path (relative
    Frobenius error <= 2e-4), and both bf16 runs against the float32
    einsum run (the kernel path no farther from it than the einsum path,
    within 25%)."""
    model.float()
    runs = both_paths(model, cfg, pre.pop("tokens"))
    h_k32, h_e32 = runs["kernel"]["h"], runs["einsum"]["h"]
    rel32 = rel_err(h_k32, h_e32)
    k16 = rel_err(pre.pop("h_kernel"), h_e32)
    e16 = rel_err(pre.pop("h_einsum"), h_e32)
    log(f"  prefill {cfg.name} float32 (same weights): kernel vs einsum "
        f"{rel32:.4e} (bound {PREFILL_F32_REL_ERR}); against the float32 einsum "
        f"run, bf16 kernel path {k16:.4e}, bf16 einsum path {e16:.4e} (bound: "
        f"kernel <= {PREFILL_BF16_RATIO} x einsum); launches "
        f"{runs['kernel']['launches']}, flash routes {runs['kernel']['routes']}, "
        f"SSD routes {runs['kernel']['ssd_routes']}")
    if not rel32 <= PREFILL_F32_REL_ERR:
        raise AssertionError(f"{cfg.name} float32 prefill: kernel vs einsum "
                             f"{rel32} > {PREFILL_F32_REL_ERR}")
    if not k16 <= PREFILL_BF16_RATIO * e16:
        raise AssertionError(f"{cfg.name} bf16 prefill: the kernel path is "
                             f"{k16} from the float32 run, the einsum path {e16}")
    return {"rel_kernel_vs_einsum_f32": rel32, "rel_bf16_kernel_vs_f32": k16,
            "rel_bf16_einsum_vs_f32": e16, "f32_routes": runs["kernel"]["routes"],
            "f32_ssd_routes": runs["kernel"]["ssd_routes"],
            "f32_kernel_s": runs["kernel"]["s"],
            "f32_einsum_s": runs["einsum"]["s"]}


def serve(model, cfg, dev) -> dict:
    """``ServeEngine(batch_size=4, cache_len=256)`` at full width answering
    the standalone demo's 8 requests (prompts of 4-23 tokens from
    ``default_rng(0)``, 16 new tokens each)."""
    from repro_torch.launch.serve import ServeEngine, standalone_requests

    eng = ServeEngine(cfg, 4, 256, model=model)
    for req in standalone_requests(8, cfg.vocab_size, 16, seed=0):
        eng.submit(req)
    t0 = time.perf_counter()
    stats = eng.run()
    wall = time.perf_counter() - t0
    if stats["completed"] != 8:
        raise AssertionError(f"{cfg.name} served {stats['completed']} of 8")
    for r in eng.completed:
        if len(r.generated) != 16 or not all(0 <= t < cfg.vocab_size
                                             for t in r.generated):
            raise AssertionError(f"{cfg.name} request {r.rid}: bad tokens")
    log(f"  serve {cfg.name} bf16: 8/8 completed in {stats['engine_steps']} engine "
        f"steps, {stats['generated_tokens']} tokens, {stats['tokens_per_sec']:.2f} "
        f"generated tokens/s ({wall / stats['engine_steps'] * 1e3:.2f} ms/step), "
        f"p50 {stats['p50_ticks']} p99 {stats['p99_ticks']} ticks")
    return {**stats, "wall_s": wall}


def serve_card_vs_cpu(arch, dev) -> dict:
    """Reduced ``arch`` in float32 on the same weights on the CPU and on the
    card: the same greedy tokens, or a near-tie in the CPU's logits where
    they first differ."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch.serve import ServeEngine, standalone_requests
    from repro_torch.models.factory import build_model

    cfg = reduced(get_arch(arch))
    cpu_model = build_model(cfg, torch.float32, device="cpu")
    card_model = build_model(cfg, torch.float32, device=dev)
    card_model.load_state_dict(cpu_model.state_dict())
    logits, runs = {}, {}
    for name, m in (("cpu", cpu_model), ("card", card_model)):
        rec, decode = [], m.decode_step

        def recording(tokens, cache, pos, decode=decode, rec=rec):
            out, cache = decode(tokens, cache, pos)
            rec.append(out.cpu())
            return out, cache

        m.decode_step = recording
        eng = ServeEngine(cfg, 4, 256, model=m)
        for req in standalone_requests(8, cfg.vocab_size, 16, seed=0):
            eng.submit(req)
        eng.run()
        logits[name] = rec
        runs[name] = {r.rid: r.generated for r in eng.completed}
    max_diff, first_split = 0.0, None
    for step, (lc, lg) in enumerate(zip(logits["cpu"], logits["card"])):
        max_diff = max(max_diff, float((lc - lg).abs().max()))
        rows = torch.nonzero(lc.argmax(-1) != lg.argmax(-1)).flatten()
        if rows.numel():
            for row in rows.tolist():
                top2 = torch.topk(lc[row], 2).values
                gap = float(top2[0] - top2[1])
                if gap >= 2 * (2e-4 + 2e-4 * abs(float(top2[0]))):
                    raise AssertionError(f"reduced {arch}: card token differs "
                                         f"at step {step} with a CPU gap {gap}")
            first_split = step
            break
    if first_split is None and runs["cpu"] != runs["card"]:
        raise AssertionError(f"reduced {arch}: card and CPU tokens differ")
    log(f"  serve reduced {arch} float32: card == CPU greedy tokens "
        f"({'all 8 requests' if first_split is None else f'until a near-tie at step {first_split}'}), "
        f"max logit difference {max_diff:.3e}")
    return {"tokens_equal": first_split is None, "max_logit_diff": max_diff}


def phase_llm(dev) -> dict:
    """Phases 6-8 per model: minitron-8b (flash), then mamba2-370m (ssd),
    each built once at full width in bf16 from seed 0 and freed after;
    then the rmsnorm kernel's shapes."""
    from repro_torch.configs import get_arch
    from repro_torch.models.factory import build_model

    out = {}
    gen = torch.Generator(device=dev)
    for arch, kernel_phase, batch in (("minitron-8b", phase_flash, 1),
                                      ("mamba2-370m", phase_ssd, 4)):
        cfg = get_arch(arch)
        gen.manual_seed(0)
        t0 = time.perf_counter()
        model = build_model(cfg, torch.bfloat16, device=dev, generator=gen)
        torch.cuda.synchronize()
        t_build = time.perf_counter() - t0
        n_params = sum(p.numel() for p in model.parameters())
        log(f"  {arch}: {n_params} parameters, {n_params * 2 / 1e9:.2f} GB in "
            f"bf16, built on the device in {t_build:.2f} s")
        t0 = time.perf_counter()
        k = kernel_phase(model, cfg, dev, gen)
        log(f"phase 6 ({arch} kernel): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        p = prefill(model, cfg, batch, 4096, dev, gen)
        log(f"phase 7 ({arch} prefill): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        s = serve(model, cfg, dev)
        s["card_vs_cpu"] = serve_card_vs_cpu(arch, dev)
        log(f"phase 8 ({arch} serving): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        p.update(prefill_accuracy(model, cfg, p))
        log(f"phase 7 ({arch} prefill in float32): {time.perf_counter() - t0:.2f} s")
        if cfg.family == "ssm":  # bf16 on the tensor cores, float32 on CUDA cores
            want = ({"mma_bf16": cfg.num_layers, "cuda_core_f32": 0},
                    {"mma_bf16": 0, "cuda_core_f32": cfg.num_layers})
            if (p["ssd_routes"], p["f32_ssd_routes"]) != want:
                raise AssertionError(f"{arch} SSD routes {p['ssd_routes']} "
                                     f"(bf16), {p['f32_ssd_routes']} (float32)")
        out[arch] = {"params": n_params, "build_s": t_build, "kernel": k,
                     "prefill": p, "serve": s}
        del model
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["rmsnorm"] = phase_rmsnorm(dev, gen)
    log(f"phase 6 (rmsnorm): {time.perf_counter() - t0:.2f} s")
    return out


# -- phase 9: the paper on the card ----------------------------------------------

PAPER_BUDGET_S = 300.0  # phase 9's aim, so the whole script stays ~10 min
PHASE10_AIM_S = 240.0  # phase 10's aim: the script within ~12 min
LAWS_AIM_S = 110.0  # of which the law sweep's 21 runs (T cut past it)
PAPER_HOST_S = 10.0  # the host's chain analysis (Theorem 1, Fig. 6 gaps)
PAPER_SPAWN_S = 20.0  # a worker process's start (the side-by-side plan)
PAPER_WORKERS = 8  # the side-by-side plan's worker processes
PAPER_MIN_T = 20_000  # the reference's quick T, the floor of any cut
PAPER_REPLAY = 2_000  # steps of each card-drawn run replayed on the CPU
PAPER_K_SWEEP = (2, 8, 32)  # graph lengths timed on Fig. 3's loop
# the runs whose uniform blocks are drawn on the card and replayed
PAPER_REPLAYED = (("ring", "mhlj"), ("barabasi_albert", "mhlj"))
PAPER_CLAIMS = {
    "fig4_erdos_renyi": {
        "homo_auc_gap": "C1: homogeneous data, uniform ~= IS (near 0)",
        "hetero_is_advantage": "C2: heterogeneous data, IS faster (> 0)",
    },
    "fig5_sparse_graphs": "C4: entrapment (*_is_occ) and the MHLJ fix "
                          "(*_mhlj_occ below it) on each sparse graph",
    "fig6_annealing": {
        "annealed_vs_const": "C5: annealing p_J -> 0 removes the gap (< 1)",
    },
}


def paper_units(fig5_tags, t5: int, t6: int) -> list:
    """Phase 9's units of work: ``(figure, Fig. 5 graph or None, training
    steps, training calls)``.  Fig. 5 runs one unit per graph; the other
    figures one unit each."""
    return ([("fig3_ring", None, 3 * 40_000, 3),
             ("fig4_erdos_renyi", None, 4 * 20_000, 4),
             ("fig6_annealing", None, 2 * t6, 2),
             ("theorem1_remark1", None, 20_000, 1)]
            + [("fig5_sparse_graphs", tag, 3 * t5, 3) for tag in fig5_tags])


def makespan(costs, workers: int) -> float:
    """The longest worker's load when the costs go, longest first, each to
    the least loaded worker (the pool's order)."""
    loads = [0.0] * workers
    for c in sorted(costs, reverse=True):
        loads[loads.index(min(loads))] += c
    return max(loads)


def paper_plan(fig5_tags, ms_step: float, call_s: float, spent_s: float,
               busy_ms_step: float) -> dict:
    """Each figure's T: the paper's, cut only where phase 9's time aim
    forces it — Fig. 5's T first, then Fig. 6's, neither below
    ``PAPER_MIN_T``, and no further than a cut shortens the phase (Fig.
    3's unit is never cut) — with the units run one after another in
    this process.  A unit costs its steps at ``ms_step`` (a W=6 fleet step
    costs one engine step) and ``call_s`` a call (set-up and capture).
    Beside it, the side-by-side plan at the chosen T: the units in
    ``PAPER_WORKERS`` processes, no shorter than the card's share, the
    steps at ``busy_ms_step`` of device time, since they share one card."""

    def costs(t5, t6):
        return [steps * ms_step / 1e3 + calls * call_s
                for _, _, steps, calls in paper_units(fig5_tags, t5, t6)]

    def estimate(t5, t6):
        return spent_s + PAPER_HOST_S + sum(costs(t5, t6))

    aim = max(PAPER_BUDGET_S, estimate(PAPER_MIN_T, PAPER_MIN_T))
    candidates = ([(t5, 40_000) for t5 in range(40_000, PAPER_MIN_T - 1, -1_000)]
                  + [(PAPER_MIN_T, t6)
                     for t6 in range(39_000, PAPER_MIN_T - 1, -1_000)])
    for t5, t6 in candidates:
        est_s = estimate(t5, t6)
        if est_s <= aim:
            break
    device_s = sum(steps for _, _, steps, _ in paper_units(fig5_tags, t5, t6)
                   ) * busy_ms_step / 1e3
    side_s = (spent_s + PAPER_SPAWN_S + PAPER_HOST_S
              + max(makespan(costs(t5, t6), PAPER_WORKERS), device_s))
    return {"fig5_T": t5, "fig6_T": t6, "estimate_s": est_s,
            "side_by_side_estimate_s": side_s, "device_s": device_s}


def paper_unit(name: str, tag, num_steps, dev,
               replayed=PAPER_REPLAYED) -> dict:
    """One unit of phase 9 (or of phase 10's law sweep): a module's ``run``
    (Fig. 5 and the law sweep: ``run_graph`` on one graph) on the card,
    its training calls recorded (time, steps, finite MSE, the graphs' K
    and capture seconds) and its sparse-kernel launches counted; the runs
    of ``replayed`` take blocks drawn on the card and keep their first
    ``PAPER_REPLAY`` steps for the CPU replay."""
    import importlib

    from repro_torch.kernels.walk_transition import kernel as wt

    mod = importlib.import_module(f"repro_torch.paper.{name}")
    gen = torch.Generator(device=dev)
    calls: list = []
    replays: dict = {}

    def blocks(*, tag, method, seed, num_steps, num_walks, r, p_j):
        if (tag, method) not in replayed:
            return None  # the call draws from its own generator
        gen.manual_seed(seed)
        u = torch.rand((num_steps, num_walks, 3 + r), generator=gen,
                       device=dev)
        flag = u[..., 0] < torch.as_tensor(p_j, device=dev)[:, None]
        u[..., 0] = flag.to(torch.float32)
        replays[tag, method] = {"u": u[:PAPER_REPLAY].cpu().numpy()}
        return u

    def recording(blocks_, tag_, method, graph, data, gamma, steps, **kw):
        t0 = time.perf_counter()
        with ScanLog() as sl:
            res = train(blocks_, tag_, method, graph, data, gamma, steps, **kw)
        calls.append({"tag": tag_, "method": method, "steps": steps,
                      "law_kwargs": kw.get("law_kwargs"),
                      "walks": kw.get("num_walks") or 1,
                      "s": time.perf_counter() - t0,
                      "chunk": sl.stats[0].chunk,
                      "capture_s": sl.stats[0].capture_s})
        if not np.isfinite(res.mse).all():
            raise AssertionError(f"{name} {tag_}/{method}: the MSE trace is "
                                 "not finite")
        if (tag_, method) in replays:
            replays[tag_, method].update(
                nodes=res.update_nodes[:PAPER_REPLAY],
                hops=res.transitions[:PAPER_REPLAY],
                mse=res.mse[:PAPER_REPLAY + 1],
                args=(graph, data, gamma,
                      {k: v for k, v in kw.items() if k != "device"}))
        return res

    train = mod.train
    mod.train = recording
    wt.walk_transition_sparse.launches = 0
    t0 = time.perf_counter()
    try:
        if tag is None:
            kwargs = {} if num_steps is None else {"num_steps": num_steps}
            out = mod.run(device=dev, blocks=blocks, **kwargs)
        else:
            out = mod.run_graph(tag, mod._graphs("full")[tag], num_steps,
                                device=dev, blocks=blocks)
    finally:
        mod.train = train
    wall = time.perf_counter() - t0
    return {"name": name, "tag": tag, "out": out, "calls": calls,
            "wall_s": wall, "launches": wt.walk_transition_sparse.launches,
            "replays": replays}


def phase_paper(dev, smi: str) -> dict:
    """Phase 9: the paper's reproduction (``repro_torch.paper``) on the
    card at the paper's graph sizes, every training step through
    ``walk_transition_sparse``, the loops captured in CUDA graphs, the
    units one after another in this process."""
    from repro_torch.core.graphs import ring
    from repro_torch.core.levy import remark1_bound
    from repro_torch.core.transition import MHLJParams
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.paper import fig5_sparse_graphs
    from repro_torch.walk_sgd import run_rw_sgd
    from repro_torch.walk_sgd import trainer as ttrain

    t_phase = time.perf_counter()
    log(f"phase 9 (the paper on the card): {smi}")

    # Fig. 3's mhlj setting alone: the loop's ms/step at W=1 over its first
    # PAPER_REPLAY steps, captured and uncaptured, graphs of each
    # PAPER_K_SWEEP length, and a profiler window of each loop
    n3 = 1000
    data3 = make_heterogeneous_regression(
        n3, dim=10, sigma_high_sq=100.0, p_high=0.002, seed=0,
        force_min_high=2, x_star_scale=10.0,
    )
    kw3 = dict(mhlj_params=MHLJParams(0.1, 0.5, 3), seed=1,
               v0=int(np.argmax(data3.lipschitz)))
    gamma3 = 0.5 / data3.lipschitz.mean()
    gen = torch.Generator(device=dev).manual_seed(1)  # as Fig. 3's block
    u3_all = torch.rand((40_000, 1, 6), generator=gen, device=dev)
    u3_all[..., 0] = (u3_all[..., 0] < np.float32(0.1)).to(torch.float32)
    u3 = u3_all[:PAPER_REPLAY]
    run_rw_sgd("mhlj", ring(n3), data3, gamma3, 50, uniforms=u3[:50],
               device=dev, **kw3)  # warm-up

    def fig3_loop(steps, capture=None):
        return timed_training(ttrain, "mhlj", ring(n3), data3, gamma3, steps,
                              entry="run_rw_sgd", capture=capture,
                              uniforms=u3_all[:steps], device=dev, **kw3)

    timed, seen = fig3_loop(PAPER_REPLAY)
    plain, seen_u = fig3_loop(PAPER_REPLAY, capture=False)
    for name in ("update_nodes", "transitions", "mse", "x_final"):
        if not np.array_equal(getattr(timed, name), getattr(plain, name)):
            raise AssertionError(f"Fig. 3 loop: captured and uncaptured "
                                 f"differ in {name}")
    loop = scan_summary(seen["scan"], seen["loop_s"])
    loop["uncaptured_ms_per_step"] = seen_u["loop_s"] * 1e3 / PAPER_REPLAY
    setup_s = seen["setup_s"]
    sweep = {}
    for k in PAPER_K_SWEEP:
        with ScanLog(chunk=k):
            _, seen_k = fig3_loop(1 + 4_000)
        sweep[k] = scan_summary(seen_k["scan"], seen_k["loop_s"])
        log(f"  Fig. 3 loop, 4,001 steps, K={k}: capture "
            f"{sweep[k]['capture_s']:.4f} s, {sweep[k]['replays']} replays, "
            f"{sweep[k]['ms_per_step']:.5f} ms/step the call, "
            f"{sweep[k]['replayed_ms_per_step']:.5f} ms/step replayed")
    prof = profile_window(lambda: fig3_loop(500),
                          "walk_transition_sparse_kernel",
                          after="scan.capture")
    prof_u = profile_window(lambda: fig3_loop(500, capture=False),
                            "walk_transition_sparse_kernel")
    loop["idle_share"], loop["idle_share_uncaptured"] = (
        prof["idle_share"], prof_u["idle_share"])
    # the card's time a step, which processes side by side would share:
    # the replayed step less its idle share
    busy_ms_step = loop["replayed_ms_per_step"] * (1.0 - (prof["idle_share"]
                                                           or 0.0))
    log(f"  Fig. 3 mhlj, ring(1000), first {PAPER_REPLAY} steps (W=1), "
        f"set-up {setup_s:.3f} s: {fmt_loop(loop)}; "
        f"captured == uncaptured bit for bit; the card busy "
        f"{busy_ms_step:.5f} ms a replayed step, walk_transition_sparse "
        f"{prof['kernel_ms']} ms/launch (CUPTI)")

    fig5_tags = list(fig5_sparse_graphs._graphs("full"))
    # a call: its set-up and the capture of at most MAX_CHUNK steps
    from repro_torch.core.scan import MAX_CHUNK
    call_s = setup_s + MAX_CHUNK * loop["uncaptured_ms_per_step"] / 1e3
    plan = paper_plan(fig5_tags, loop["replayed_ms_per_step"], call_s,
                      time.perf_counter() - t_phase, busy_ms_step)
    cuts = [f"{fig}: T 40000 -> {plan[key]}"
            for fig, key in (("fig5_sparse_graphs", "fig5_T"),
                             ("fig6_annealing", "fig6_T"))
            if plan[key] < 40_000]
    log(f"  plan: one process, Fig. 5 T={plan['fig5_T']}, Fig. 6 "
        f"T={plan['fig6_T']}, phase 9 estimated {plan['estimate_s']:.0f} s "
        f"(the side-by-side plan, {PAPER_WORKERS} workers sharing the card's "
        f"{plan['device_s']:.0f} s of device time: "
        f"{plan['side_by_side_estimate_s']:.0f} s); T cuts: "
        + ("; ".join(cuts) if cuts else "none"))
    if plan["estimate_s"] > PAPER_BUDGET_S:
        log(f"  over the {PAPER_BUDGET_S:.0f} s aim at the least T; the next "
            "cut would be an earlier phase's depth")

    steps_of = {"fig5_sparse_graphs": plan["fig5_T"],
                "fig6_annealing": plan["fig6_T"]}
    units = paper_units(fig5_tags, plan["fig5_T"], plan["fig6_T"])
    t0 = time.perf_counter()
    done = [paper_unit(name, tag, steps_of.get(name), dev)
            for name, tag, _, _ in units]
    t_units = time.perf_counter() - t0
    log(f"  the {len(units)} units in one process: {t_units:.2f} s")

    figures: dict = {}
    replay_runs: dict = {}
    for name in ("fig3_ring", "fig4_erdos_renyi", "fig5_sparse_graphs",
                 "fig6_annealing", "theorem1_remark1"):
        parts = [d for d in done if d["name"] == name]
        calls = [c for d in parts for c in d["calls"]]
        steps = sum(c["steps"] for c in calls)
        launches = sum(d["launches"] for d in parts)
        if launches != steps or steps == 0:
            raise AssertionError(f"{name}: {launches} sparse-kernel launches "
                                 f"for {steps} training steps")
        if name == "fig5_sparse_graphs":
            out = {"T": plan["fig5_T"],
                   **{d["tag"]: d["out"] for d in parts}}
            out["derived"] = fig5_sparse_graphs.derived(out, fig5_tags)
        else:
            out = parts[0]["out"]
        train_s = sum(c["s"] for c in calls)
        figures[name] = {
            "wall_s": sum(d["wall_s"] for d in parts), "train_s": train_s,
            "steps": steps, "ms_per_step": train_s / steps * 1e3,
            "launches": launches, "calls": calls,
            "units_wall_s": {d["tag"] or name: d["wall_s"] for d in parts},
            "derived": out["derived"],
            **({"T": steps_of[name]} if name in steps_of else {}),
        }
        if name == "fig6_annealing":
            figures[name]["p_j_sweep"] = out["p_j_sweep"]
        for d in parts:
            replay_runs.update(d["replays"])
        log(f"  {name}: {figures[name]['wall_s']:.2f} s wall, {steps} steps "
            f"in {len(calls)} runs, {train_s / steps * 1e3:.5f} ms/step "
            f"(captured, set-up and capture included; K "
            f"{sorted({c['chunk'] for c in calls})}, capture "
            f"{sum(c['capture_s'] for c in calls):.3f} s in all), "
            f"walk_transition_sparse launches={launches}")
        log(f"    derived: {json.dumps(out['derived'])}")

    # the card-drawn runs, their first PAPER_REPLAY steps replayed on the
    # CPU with the figure's own graph, data and settings
    replays = {}
    for tag, method in PAPER_REPLAYED:
        card = replay_runs[tag, method]
        graph, data, gamma, kw = card["args"]
        cpu = run_rw_sgd(method, graph, data, gamma, PAPER_REPLAY,
                         uniforms=torch.from_numpy(card["u"]), device="cpu",
                         **kw)
        same = (np.array_equal(card["nodes"], cpu.update_nodes)
                and np.array_equal(card["hops"], cpu.transitions))
        if tag == "ring":  # the timed run is Fig. 3's first steps
            same = (same and np.array_equal(card["u"], u3.cpu().numpy())
                    and np.array_equal(timed.update_nodes, cpu.update_nodes))
        mse_rel = float(np.max(np.abs(card["mse"] - cpu.mse)
                               / np.abs(cpu.mse)))
        width = int(graph.degrees.max())
        replays[tag] = {"equal": same, "width": width, "mse_max_rel": mse_rel}
        log(f"  replay {tag} (max width {width}): first {PAPER_REPLAY} update "
            f"nodes and hops card == CPU: {same}; MSE max rel diff "
            f"{mse_rel:.3g}")
        if not same:
            raise AssertionError(f"{tag}: the card's walk differs from the "
                                 "CPU replay")

    # the claims the reference's tests assert, as hard gates
    d3 = figures["fig3_ring"]["derived"]
    dt1 = figures["theorem1_remark1"]["derived"]
    f6 = figures["fig6_annealing"]
    gaps = list(f6["p_j_sweep"].values())
    gates = {
        "fig3 is_entrapped_occupancy > mhlj_occupancy":
            d3["is_entrapped_occupancy"] > d3["mhlj_occupancy"],
        "fig3 mhlj_vs_is_early_ratio < 1": d3["mhlj_vs_is_early_ratio"] < 1,
        "fig3 mhlj_comm_overhead <= remark1_bound(0.1, 0.5, 3)":
            d3["mhlj_comm_overhead"] <= remark1_bound(0.1, 0.5, 3),
        "theorem1 ring_tau_ratio > 1": dt1["ring_tau_ratio"] > 1,
        "theorem1 ws_tau_ratio > 1": dt1["ws_tau_ratio"] > 1,
        "theorem1 remark1_within": bool(dt1["remark1_within"]),
        "fig6 gaps strictly decrease":
            all(a > b for a, b in zip(gaps, gaps[1:])),
        "fig6 final_slope > 1.5": f6["derived"]["final_slope"] > 1.5,
        "fig6 gap_shrink < 0.05": f6["derived"]["gap_shrink"] < 0.05,
    }
    for name, ok in gates.items():
        log(f"  gate {name}: {'pass' if ok else 'FAIL'}")
    for fig, claims in PAPER_CLAIMS.items():
        d = figures[fig]["derived"]
        if isinstance(claims, str):
            log(f"  reported {fig} ({claims}): " + ", ".join(
                f"{k}={v:.6g}" for k, v in d.items()))
        else:
            for k, claim in claims.items():
                log(f"  reported {fig} {k}={d[k]:.6g} ({claim})")
    failed = [name for name, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"paper claims failed on the card: {failed}")
    return {"loop_first": loop, "setup_s_first": setup_s,
            "k_sweep": sweep, "busy_ms_per_step": busy_ms_step,
            "profile": {k: v for k, v in prof.items()
                        if not k.startswith("device_")},
            "profile_uncaptured": {k: v for k, v in prof_u.items()
                                   if not k.startswith("device_")},
            "plan": plan, "cuts": cuts, "units_s": t_units,
            "wall_s": time.perf_counter() - t_phase,
            "figures": figures, "replays": replays, "gates": gates}




# -- phase 10: the other chain laws and the fault path ---------------------------

LAWS_FULL_T = 40_000  # the reference's full T
LAWS_MIN_T = 15_000  # the reference's quick T, the floor of any cut
LAWS_REPLAYED = (("ba", "heterogeneity"),)  # card-drawn, replayed on the CPU
# the main path's trainer of phase 3 (large_graph_walk's): BA(n, m) ragged
FAULT_GRAPH, FAULT_STEPS, FAULT_WALKS, FAULT_AVG = (100_000, 3), 500, 2048, 50
FIG6_SEEDS = (1, 2, 3, 4)  # Fig. 6's stream seeds beyond phase 9's


def counts_zero(wt) -> None:
    for fn in (wt.walk_transition_sparse, wt.walk_transition,
               wt.walk_transition_ragged):
        fn.launches = 0


def counts_read(wt) -> dict:
    return {"walk_transition_sparse": wt.walk_transition_sparse.launches,
            "walk_transition": wt.walk_transition.launches,
            "walk_transition_ragged": wt.walk_transition_ragged.launches}


def replay_on_cpu(card: dict, method: str, where: str) -> dict:
    """A card run's first ``PAPER_REPLAY`` steps (blocks drawn on the card)
    run again on the CPU plain path: update nodes and hops bit for bit."""
    from repro_torch.walk_sgd import run_rw_sgd

    graph, data, gamma, kw = card["args"]
    cpu = run_rw_sgd(method, graph, data, gamma, PAPER_REPLAY,
                     uniforms=torch.from_numpy(card["u"]), device="cpu", **kw)
    same = (np.array_equal(card["nodes"], cpu.update_nodes)
            and np.array_equal(card["hops"], cpu.transitions))
    mse_rel = float(np.max(np.abs(card["mse"] - cpu.mse) / np.abs(cpu.mse)))
    log(f"  replay {where} (max width {int(graph.degrees.max())}): first "
        f"{PAPER_REPLAY} update nodes and hops card == CPU: {same}; MSE max "
        f"rel diff {mse_rel:.3g}")
    if not same:
        raise AssertionError(f"{where}: the card's walk differs from the "
                             "CPU replay")
    return {"equal": same, "mse_max_rel": mse_rel}


def phase10_law_sweep(dev, wt, ms_step: float) -> dict:
    """(a) ``repro_torch.paper.law_sweep`` at the reference's full tier:
    three graphs, seven laws, W=1 on the sparse layout (one sparse launch a
    step, checked); T cut only where ``ms_step`` says the 21 runs would pass
    LAWS_AIM_S, never below LAWS_MIN_T; every Herfindahl key beside the
    reference's, finite; a card-drawn heterogeneity run replayed on the
    CPU."""
    from repro_torch.paper import law_sweep

    runs = 3 * len(law_sweep.LAWS)
    T = LAWS_FULL_T
    while T > LAWS_MIN_T and runs * T * ms_step / 1e3 > LAWS_AIM_S:
        T -= 1_000
    est = runs * T * ms_step / 1e3
    cut = f"T {LAWS_FULL_T} -> {T}" if T < LAWS_FULL_T else "none"
    log(f"  (a) law sweep plan: {runs} runs at T={T}, estimated {est:.0f} s "
        f"at {ms_step:.5f} ms/step (Fig. 5's, set-up and capture included); "
        f"T cut: {cut}")
    with open(os.path.join(ROOT, "results", "BENCH_law_sweep.json")) as fh:
        ref = json.load(fh)["derived"]
    counts_zero(wt)
    t0 = time.perf_counter()
    units = [paper_unit("law_sweep", tag, T, dev, replayed=LAWS_REPLAYED)
             for tag in law_sweep._graphs("full")]
    wall = time.perf_counter() - t0
    # paper_unit counts each unit's sparse launches from 0
    launches = dict(counts_read(wt),
                    walk_transition_sparse=sum(u["launches"] for u in units))
    derived, calls, replays = {}, [], {}
    for u in units:
        derived.update(u["out"][1])
        calls += u["calls"]
        replays.update(u["replays"])
    steps = sum(c["steps"] for c in calls)
    if launches["walk_transition_sparse"] != steps or steps != runs * T:
        raise AssertionError(f"law sweep: {launches} launches for {steps} "
                             "training steps")
    missing = sorted(set(ref) - set(derived))
    bad = sorted(k for k, v in derived.items() if not np.isfinite(v))
    if missing or bad:
        raise AssertionError(f"law sweep keys missing {missing}, not finite "
                             f"{bad}")
    for c in calls:
        law = c["method"] + (f" {c['law_kwargs']}" if c["law_kwargs"] else "")
        log(f"    {c['tag']}/{law}: {c['s']:.2f} s, "
            f"{c['s'] / c['steps'] * 1e3:.5f} ms/step (set-up and capture "
            f"included; K {c['chunk']}, capture {c['capture_s']:.4f} s)")
    for k in sorted(derived):
        log(f"    {k} = {derived[k]:.6g} (reference {ref[k]:.6g})")
    tag, method = LAWS_REPLAYED[0]
    replay = replay_on_cpu(replays[tag, method], method,
                           f"law sweep {tag}/{method}")
    train_s = sum(c["s"] for c in calls)
    log(f"  (a) law sweep: {wall:.2f} s wall, {steps} steps in {len(calls)} "
        f"runs, {train_s / steps * 1e3:.5f} ms/step, sparse launches "
        f"{launches['walk_transition_sparse']}; all {len(derived)} keys "
        "present and finite")
    return {"T": T, "cut": cut, "estimate_s": est, "wall_s": wall,
            "ms_per_step": train_s / steps * 1e3, "calls": calls,
            "derived": derived, "reference": ref, "launches": launches,
            "replay": replay}


def faulted_loop(fleet, args, fm, steps, dev, *, capture=None, gen_seed=0,
                 **kw):
    """``run_fleet(faults=fm)`` for ``steps`` steps from a generator seeded
    ``gen_seed``; returns its outputs, seconds, ``ScanStats`` and the
    generator's final state."""
    from repro_torch.models import regression as treg
    from repro_torch.walk_sgd import fleet as tfleet

    x0, feats, targs, weights, gamma, sched = args
    gen = kw.pop("generator", None)
    if gen is None:
        gen = torch.Generator(device=dev).manual_seed(gen_seed)
    start = kw.pop("start_step", 0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ScanLog() as sl:
        out = tfleet.run_fleet(
            kw.pop("xs", x0), feats, targs, weights, fleet, steps, gamma,
            sched[start:start + steps], True, treg.linear_grad,
            generator=gen, faults=fm, capture=capture, start_step=start,
            **kw)
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0, sl.stats[0], gen.get_state()


def same_fleet_run(a, b, where: str) -> None:
    for i, name in enumerate(("models", "mse", "avg_mse", "update_nodes",
                              "hops")):
        if not torch.equal(a[i], b[i]):
            raise AssertionError(f"{where}: runs differ in {name}")
    for k in ("nodes", "rescued", "blocked"):
        if not torch.equal(a[5][k], b[5][k]):
            raise AssertionError(f"{where}: runs differ in {k}")
    for k in ("live", "blocked", "t"):
        if not torch.equal(getattr(a[5]["fault_state"], k),
                           getattr(b[5]["fault_state"], k)):
            raise AssertionError(f"{where}: fault states differ in {k}")


def phase10_trainers(dev, wt, ttrain, params) -> dict:
    """(b) the main path's trainer (BA(100k,3) ragged, W=2048, avg_every=50,
    500 steps) under the private and heterogeneity laws and, under MHLJ,
    under Markov faults (rescue on and off) and under dead hubs with a cut
    partition; each captured against uncaptured, bit for bit, with its
    ms/step, idle share and fault totals.  (c) a kill-and-restore through
    disk, bit for bit."""
    import dataclasses

    from repro_torch import interop
    from repro_torch.core import faults as tfaults
    from repro_torch.core.graphs import barabasi_albert
    from repro_torch.core.heterogeneity import project_to_simplex
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import fleet as tfleet

    out: dict = {"trainers": {}, "faults": {}}
    t0 = time.perf_counter()
    g = barabasi_albert(*FAULT_GRAPH, seed=0, layout="ragged")
    data = make_heterogeneous_regression(
        g.n, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
        x_star_scale=3.0,
    )
    gamma = float(0.3 / data.lipschitz.mean())
    lips = np.asarray(data.lipschitz, np.float64)
    # heterogeneity_pi's (n, n) H would be 80 GB here: a stand-in target,
    # the floored importance distribution, passed through law_kwargs
    pi = project_to_simplex(lips / lips.sum(), 0.25)
    log(f"  BA{FAULT_GRAPH} and data built: {time.perf_counter() - t0:.2f} s")
    for name, method, law_kwargs in (
            ("private_g0.1", "private", {"gamma": 0.1}),
            ("heterogeneity_pi", "heterogeneity", {"pi": pi})):
        counts_zero(wt)
        res, seen = timed_training(
            ttrain, method, g, data, gamma, FAULT_STEPS, FAULT_WALKS,
            avg_every=FAULT_AVG, seed=0, device=dev, law_kwargs=law_kwargs)
        launches = counts_read(wt)
        if launches["walk_transition_ragged"] != FAULT_STEPS:
            raise AssertionError(f"{name} trainer: {launches}")
        if not (np.isfinite(res.mse).all() and np.isfinite(res.avg_mse).all()):
            raise AssertionError(f"{name} trainer: MSE not finite")
        loop = trainer_loop_check(ttrain, res, seen,
                                  f"trainer {name} ragged W={FAULT_WALKS}")
        out["trainers"][name] = {
            "setup_s": seen["setup_s"], "launches": launches, "loop": loop,
            "avg_mse_first": float(res.avg_mse[0]),
            "avg_mse_last": float(res.avg_mse[-1])}
        log(f"  trainer {name}: set-up {seen['setup_s']:.2f} s, avg_mse "
            f"{res.avg_mse[0]:.4f} -> {res.avg_mse[-1]:.4f}, "
            f"{launches['walk_transition_ragged']} ragged launches")

    # MHLJ under faults, through run_fleet with the trainer's engine
    rows, weights, sched, p_d, r, _ = ttrain._setup_method(
        "mhlj", g, data, params, None, FAULT_STEPS)
    eng = ttrain._build_engine(g, p_d, r, rows, None, dev)
    fleet = tfleet.WalkFleet.create(eng, FAULT_WALKS, seed=0,
                                    avg_every=FAULT_AVG)
    args = (torch.zeros(FAULT_WALKS, data.dim, device=dev),
            torch.as_tensor(np.asarray(data.features, np.float32), device=dev),
            torch.as_tensor(np.asarray(data.targets, np.float32), device=dev),
            torch.as_tensor(weights, device=dev), gamma,
            torch.as_tensor(sched, device=dev))
    markov = tfaults.FaultModel(crash_rate=0.05, recovery_rate=0.02,
                                patience=2, rescue=True)
    # the hubs die and the cut opens at step 100 for 200 steps (of 500)
    at, duration = FAULT_STEPS // 5, 2 * FAULT_STEPS // 5
    hubs = tfaults.kill_top_hubs(g.degrees, 10, at=at, duration=duration,
                                 device=dev, patience=2)
    cut = tfaults.partition_groups(g.indptr, g.indices,
                                   np.arange(g.n) < g.n // 2, at=at,
                                   duration=duration, device=dev)
    scenarios = {
        "markov_rescue": markov,
        "markov_no_rescue": dataclasses.replace(markov, rescue=False),
        "hubs_and_cut": dataclasses.replace(
            hubs, edge_down_at=cut.edge_down_at, edge_up_at=cut.edge_up_at),
    }
    kept = {}
    for name, fm in scenarios.items():
        counts_zero(wt)
        cap, cap_s, stats, cap_gen = faulted_loop(fleet, args, fm,
                                                  FAULT_STEPS, dev)
        launches = counts_read(wt)
        if launches["walk_transition_ragged"] != FAULT_STEPS:
            raise AssertionError(f"faulted {name}: {launches}")
        unc, unc_s, _, unc_gen = faulted_loop(fleet, args, fm, FAULT_STEPS,
                                              dev, capture=False)
        same_fleet_run(cap, unc, f"faulted {name} captured vs uncaptured")
        if not torch.equal(cap_gen, unc_gen):
            raise AssertionError(f"faulted {name}: generator states differ")
        rescued = int(cap[5]["rescued"].sum())
        blocked = int(cap[5]["blocked"].sum())
        if not fm.rescue and rescued:
            raise AssertionError(f"faulted {name}: {rescued} rescues with the "
                                 "rescue off")
        prof = profile_window(
            lambda: faulted_loop(fleet, args, fm, PROFILE_STEPS, dev),
            "walk_transition", after="scan.capture")
        prof_u = profile_window(
            lambda: faulted_loop(fleet, args, fm, PROFILE_STEPS, dev,
                                 capture=False), "walk_transition")
        loop = scan_summary(stats, cap_s)
        loop.update(uncaptured_ms_per_step=unc_s * 1e3 / FAULT_STEPS,
                    idle_share=prof["idle_share"],
                    idle_share_uncaptured=prof_u["idle_share"])
        avg = cap[2].cpu().numpy()
        out["faults"][name] = {"loop": loop, "launches": launches,
                               "rescued": rescued, "blocked": blocked,
                               "avg_mse_first": float(avg[0]),
                               "avg_mse_last": float(avg[-1])}
        log(f"  faulted {name} (MHLJ, W={FAULT_WALKS}): {fmt_loop(loop)}; "
            f"rescued {rescued}, blocked {blocked} walker-steps; avg_mse "
            f"{avg[0]:.4f} -> {avg[-1]:.4f}; captured == uncaptured bit for "
            "bit (walks, hops, models, totals, fault state, generator)")
        kept[name] = cap
    # edge_slot_lookup alone, on the hubs_and_cut run's walk pairs
    nodes = kept["hubs_and_cut"][3]
    pairs = [(nodes[:, t].contiguous(), nodes[:, t + 1].contiguous())
             for t in range(at, min(at + 50, FAULT_STEPS - 1))]
    def lookup(i):
        return tfaults.edge_slot_lookup(eng.indptr, eng.indices, *pairs[i],
                                        eng.max_degree)

    slot_ms, slot_host_ms, _ = device_time_ms(lookup, len(pairs))
    prof = profile_window(lambda: [lookup(i) for i in range(len(pairs))], "")
    slot_t = {"events_ms": slot_ms, "host_ms": slot_host_ms,
              "cupti_busy_ms": prof["busy_ms"] / len(pairs),
              "device_ops": sum(prof["device_launches_by_name"].values())
              // len(pairs)}
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    tfaults.edge_slot_lookup(eng.indptr, eng.indices, *pairs[0],
                             eng.max_degree)
    torch.cuda.synchronize()
    slot_mem = torch.cuda.max_memory_allocated() - base
    out["edge_slot_lookup"] = {"width": eng.max_degree, "walks": FAULT_WALKS,
                               "entries": FAULT_WALKS * eng.max_degree,
                               "time": slot_t, "peak_bytes": slot_mem}
    log(f"  edge_slot_lookup W={FAULT_WALKS} x width {eng.max_degree} "
        f"({FAULT_WALKS * eng.max_degree} entries): {slot_ms:.5f} ms by "
        f"events, {slot_t['cupti_busy_ms']:.5f} ms busy by CUPTI in "
        f"{slot_t['device_ops']} device ops a call; peak "
        f"{slot_mem / 2**20:.2f} MiB above the inputs")

    # (c) kill at step 250 of the Markov run, restore from disk, resume
    fm = scenarios["markov_rescue"]
    half = FAULT_STEPS // 2
    gen = torch.Generator(device=dev).manual_seed(0)
    a, _, _, _ = faulted_loop(fleet, args, fm, half, dev, generator=gen,
                              total_steps=FAULT_STEPS)
    st = a[5]["fault_state"]
    path = os.path.join(ROOT, "build", "phase10_fleet.npz")
    tfleet.save_fleet_checkpoint(
        path, dataclasses.replace(fleet, nodes=a[5]["nodes"]), step=half,
        extras={"xs": a[0], "fault_live": st.live,
                "fault_blocked": st.blocked, "fault_t": st.t,
                "generator": gen.get_state()})
    loaded, step, ex = tfleet.load_fleet_checkpoint(path, device=dev)
    gen_b = torch.Generator(device=dev)
    gen_b.set_state(torch.from_numpy(ex["generator"]))
    state = interop.fault_state_from_reference(
        live=ex["fault_live"], blocked=ex["fault_blocked"], t=ex["fault_t"],
        device=dev)
    b, _, _, _ = faulted_loop(
        loaded, args, fm, FAULT_STEPS - half, dev, generator=gen_b,
        xs=torch.as_tensor(ex["xs"], device=dev), fault_state=state,
        start_step=half, total_steps=FAULT_STEPS)
    full = kept["markov_rescue"]
    stitched = (b[0], torch.cat([a[1], b[1][:, 1:]], dim=1),
                torch.cat([a[2], b[2][1:]]), torch.cat([a[3], b[3]], dim=1),
                torch.cat([a[4], b[4]], dim=1),
                {"nodes": b[5]["nodes"], "fault_state": b[5]["fault_state"],
                 "rescued": torch.cat([a[5]["rescued"], b[5]["rescued"]]),
                 "blocked": torch.cat([a[5]["blocked"], b[5]["blocked"]])})
    same_fleet_run(stitched, full, "kill-and-restore")
    size = os.path.getsize(path)
    os.unlink(path)
    out["restore"] = {"step": step, "checkpoint_bytes": size,
                      "equal": True}
    log(f"  (c) kill-and-restore: [0, {half}) + checkpoint ({size} bytes, "
        f"models, FaultState and generator state as extras) + [{half}, "
        f"{FAULT_STEPS}) == the uninterrupted run, bit for bit")
    return out


def phase10_fault_sweep(dev, wt) -> dict:
    """(d) the fault sweep's training leg at its full scale: the criterion
    beside the reference's, the rescue ordering at 5% gated on both
    families, the "within ~2x" claim reported."""
    from repro_torch.paper import fault_sweep

    with open(os.path.join(ROOT, "results", "BENCH_faults.json")) as fh:
        ref = json.load(fh)
    counts_zero(wt)
    t0 = time.perf_counter()
    res = fault_sweep.run(scale="full", device=dev)
    wall = time.perf_counter() - t0
    launches = counts_read(wt)
    legs = 1 + 2 * len(fault_sweep.RATES["full"])
    steps = legs * fault_sweep.SCALES["full"]["steps"]
    if (launches["walk_transition_sparse"] != steps
            or launches["walk_transition_ragged"] != steps):
        raise AssertionError(f"fault sweep: {launches} for {steps} steps a "
                             "family")
    gates = {}
    for fam, legs_out in res["train"].items():
        on = legs_out["f5_with_rescue"]["excess_vs_fault_free"]
        off = legs_out["f5_no_rescue"]["excess_vs_fault_free"]
        gates[f"{fam} f5 no_rescue > with_rescue"] = off > on
        log(f"    {fam}: f5 excess/fault-free with rescue {on:.4g}, without "
            f"{off:.4g}; rescues "
            f"{legs_out['f5_with_rescue']['rescues']}, blocked "
            f"{legs_out['f5_no_rescue']['blocked_steps']} (rescue off)")
    for k in sorted(res["derived"]):
        log(f"    {k} = {res['derived'][k]:.6g} (reference "
            f"{ref['derived'][k]:.6g})")
    crit = res["criterion"]
    within = crit["dumbbell_f5_with_rescue_vs_fault_free"] <= 2.0
    log(f"  (d) fault sweep: {wall:.2f} s; criterion {json.dumps(crit)} "
        f"(reference {json.dumps(ref['criterion'])}); the reference's "
        f"\"within ~2x\" claim on this stream: "
        f"{'holds' if within else 'does not hold'} (reported, not gated); "
        f"launches {launches}")
    for name, ok in gates.items():
        log(f"  gate {name}: {'pass' if ok else 'FAIL'}")
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"fault sweep: {failed}")
    return {"wall_s": wall, "launches": launches, "criterion": crit,
            "reference_criterion": ref["criterion"], "within_2x": within,
            "derived": res["derived"], "gates": gates}


def phase10_fig6_seeds(dev, wt) -> dict:
    """(e) Fig. 6's ``annealed_vs_const`` on FIG6_SEEDS more streams: both
    runs of a seed draw their blocks on the card from a generator seeded
    with it, as the reference's two runs share its key."""
    from repro_torch.paper import fig6_annealing

    def card_blocks(stream_seed):
        gen = torch.Generator(device=dev)

        def blocks(*, num_steps, num_walks, r, p_j, **_):
            gen.manual_seed(stream_seed)
            u = torch.rand((num_steps, num_walks, 3 + r), generator=gen,
                           device=dev)
            u[..., 0] = (u[..., 0] < torch.as_tensor(p_j, device=dev)[:, None]
                         ).to(torch.float32)
            return u

        return blocks

    out = {}
    for seed in FIG6_SEEDS:
        counts_zero(wt)
        t0 = time.perf_counter()
        res = fig6_annealing.run(device=dev, blocks=card_blocks(seed))
        out[seed] = {"annealed_vs_const": res["derived"]["annealed_vs_const"],
                     "s": time.perf_counter() - t0,
                     "launches": counts_read(wt)["walk_transition_sparse"]}
        log(f"  (e) Fig. 6 stream seed {seed}: annealed_vs_const "
            f"{out[seed]['annealed_vs_const']:.6g} ({out[seed]['s']:.2f} s, "
            f"{out[seed]['launches']} sparse launches)")
    return out


def phase_laws_faults(dev, smi, p9: dict) -> dict:
    """Phase 10: the chain laws and the fault path on the card."""
    from repro_torch.core.transition import MHLJParams
    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.walk_sgd import trainer as ttrain

    t_phase = time.perf_counter()
    log(f"phase 10 (laws and faults): {smi}; aim {PHASE10_AIM_S:.0f} s")
    out = {"law_sweep": phase10_law_sweep(
        dev, wt, p9["figures"]["fig5_sparse_graphs"]["ms_per_step"])}
    out.update(phase10_trainers(dev, wt, ttrain, MHLJParams(0.1, 0.5, 3)))
    out["fault_sweep"] = phase10_fault_sweep(dev, wt)
    out["fig6_seeds"] = phase10_fig6_seeds(dev, wt)
    out["wall_s"] = time.perf_counter() - t_phase
    return out


# ---------------------------------------------------------------------------
# phase 11: dynamic graphs
# ---------------------------------------------------------------------------

PHASE11_AIM_S = 120.0  # phase 11's aim
# the reference's churn sweep at its full tier (large_graph_walk.py
# _churn_sweep): BA(n, m) ragged, Lipschitz exp(N(0,1)) from seed 5, one
# batch of CHURN_FRACTION of the undirected edges
CHURN_GRAPH, CHURN_SEED, CHURN_FRACTION = (100_000, 3), 5, 0.001
P11_WALKS, P11_STEPS = 2048, 200  # (b) walks on the churned engine
P11_TRAIN_STEPS = 500  # (c) each segment of the trainer across the churn
# (d) run_dada at the Dada scale
DADA_N, DADA_KW = 2000, dict(rounds=4, num_steps=500, num_walks=64, k=3,
                             avg_every=25, seed=0)
SBM_SIZES, SBM_P = [250] * 4, (0.1, 0.004)  # (e) Fig. 5's SBM 4x250


def churn_batch(g, rng):
    """The churn sweep's batch: half the budget deletes between nodes of
    degree >= 4 (halved and retried while a delete disconnects), the rest
    uniform non-edge inserts; returns ``(insert, delete, undirected
    edges)``."""
    from repro_torch.core.graphs import apply_edge_churn

    n = g.n
    deg = np.asarray(g.degrees, np.int64)
    src = np.repeat(np.arange(n, dtype=np.int64),
                    np.diff(np.asarray(g.indptr, np.int64)))
    dst = np.asarray(g.indices, np.int64)
    keep = src < dst
    pairs = np.stack([src[keep], dst[keep]], axis=1)
    budget = max(2, int(CHURN_FRACTION * pairs.shape[0]))
    cand = pairs[(deg[pairs[:, 0]] >= 4) & (deg[pairs[:, 1]] >= 4)]
    k_del = min(budget // 2, cand.shape[0])
    dele = None
    while k_del:
        sel = rng.choice(cand.shape[0], size=k_del, replace=False)
        try:
            apply_edge_churn(g, delete=cand[sel], check_connectivity=True)
        except ValueError:
            k_del //= 2
            continue
        dele = cand[sel]
        break
    num_del = 0 if dele is None else dele.shape[0]
    codes = set((pairs[:, 0] * n + pairs[:, 1]).tolist())
    ins = []
    while len(ins) < budget - num_del:
        a, b = (int(x) for x in rng.integers(0, n, size=2))
        if a == b:
            continue
        lo, hi = min(a, b), max(a, b)
        if lo * n + hi in codes:
            continue
        codes.add(lo * n + hi)
        ins.append((lo, hi))
    return np.asarray(ins, np.int64), dele, int(pairs.shape[0])


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return torch.equal(a.cpu().view(torch.int32), b.cpu().view(torch.int32))


def phase11_churn_sweep(dev, params) -> dict:
    """(a) the churn sweep at its full tier: the incremental path
    (``apply_edge_churn`` + ``WalkEngine.apply_churn``) against a rebuild
    (``from_edges`` + ``from_graph``), each warmed once and timed the
    second time; the patched CDF equals the card's rebuild and the CPU's
    patch bit for bit."""
    from repro_torch import interop
    from repro_torch.core.engine import WalkEngine
    from repro_torch.core.graphs import (apply_edge_churn, barabasi_albert,
                                         from_edges)

    n, m = CHURN_GRAPH
    g = barabasi_albert(n, m, seed=0, layout="ragged")
    rng = np.random.default_rng(CHURN_SEED)
    lips = np.exp(rng.normal(0.0, 1.0, n))
    eng = WalkEngine.from_graph(g, params, lipschitz=lips, device=dev)
    ins, dele, num_pairs = churn_batch(g, rng)

    def incremental():
        g2, churn = apply_edge_churn(g, insert=ins, delete=dele)
        e2 = eng.apply_churn(g2, churn, lipschitz=lips)
        torch.cuda.synchronize()
        return g2, churn, e2

    g2, churn, e_inc = incremental()  # warm
    src2 = np.repeat(np.arange(n, dtype=np.int64),
                     np.diff(np.asarray(g2.indptr, np.int64)))
    dst2 = np.asarray(g2.indices, np.int64)
    keep2 = src2 < dst2

    def rebuild():
        g3 = from_edges(n, src2[keep2], dst2[keep2], layout="ragged")
        e3 = WalkEngine.from_graph(g3, params, lipschitz=lips, device=dev)
        torch.cuda.synchronize()
        return g3, e3

    rebuild()  # warm
    t0 = time.perf_counter()
    g2, churn, e_inc = incremental()
    inc_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    g3, e_reb = rebuild()
    reb_s = time.perf_counter() - t0
    for f in ("indptr", "indices", "degrees"):
        if not np.array_equal(getattr(g2, f), getattr(g3, f)):
            raise AssertionError(f"churned graph differs from rebuild in {f}")
    if not same_bits(e_inc.edge_cdf, e_reb.edge_cdf):
        raise AssertionError("patched CDF on the card differs from the "
                             "card's from-scratch build")
    cpu_eng, _, _ = interop.from_reference_state(
        indptr=g.indptr, indices=g.indices, degrees=g.degrees,
        edge_cdf=eng.edge_cdf.cpu().numpy(), max_degree=eng.max_degree,
        cdf_width=eng.cdf_width, p_d=params.p_d, r=params.r, device="cpu")
    t0 = time.perf_counter()
    cpu_patch = cpu_eng.apply_churn(g2, churn, lipschitz=lips)
    cpu_s = time.perf_counter() - t0
    if not same_bits(e_inc.edge_cdf, cpu_patch.edge_cdf):
        raise AssertionError("patched CDF on the card differs from the "
                             "CPU's patch")
    touched = int(churn.touched_rows.size)
    ratio = reb_s / inc_s
    log(f"  (a) churn sweep BA({n},{m}): {ins.shape[0]} inserts + "
        f"{0 if dele is None else dele.shape[0]} deletes of {num_pairs} "
        f"undirected edges; touched_rows {touched} ({touched / n:.4f} of "
        f"rows); max degree {eng.max_degree} -> {e_inc.max_degree}, "
        f"cdf_width {e_inc.cdf_width}; incremental {inc_s:.4f} s, rebuild "
        f"{reb_s:.4f} s, ratio {ratio:.2f}x; patched CDF == card rebuild == "
        f"CPU patch ({cpu_s:.2f} s) bit for bit")
    return {"out": {"inserts": int(ins.shape[0]),
                    "deletes": 0 if dele is None else int(dele.shape[0]),
                    "undirected_edges": num_pairs, "touched_rows": touched,
                    "max_degree": [eng.max_degree, e_inc.max_degree],
                    "cdf_width": e_inc.cdf_width, "incremental_s": inc_s,
                    "rebuild_s": reb_s, "ratio": ratio, "cpu_patch_s": cpu_s,
                    "bitwise": True},
            "g2": g2, "engine": e_inc, "lips": lips, "batch": (ins, dele)}


def phase11_walks(dev, wt, teng, params, g2, e2, lips) -> dict:
    """(b) walks on the churned engine: the ragged kernel against its plain
    version on the churned buffers; P11_STEPS steps captured and
    uncaptured from one generator state, bit for bit; one step of fresh
    sparse, dense and bucketed engines of the churned graph equal to the
    ragged step."""
    from repro_torch.kernels.walk_transition.ref import (
        walk_transition_ragged_ref,
    )

    out: dict = {"kernel_vs_plain": []}
    w = P11_WALKS
    gen = torch.Generator(device=dev).manual_seed(11)
    hub = int(np.argmax(g2.degrees))
    kargs = (e2.indptr, e2.degrees, e2.indices, e2.edge_cdf)
    kw = dict(p_d=params.p_d, r=params.r, max_degree=e2.max_degree)
    for hub_walks in (w // 16 + 1, w):
        nodes = torch.randint(0, g2.n, (w,), generator=gen, device=dev,
                              dtype=torch.int32)
        nodes[:hub_walks] = hub
        u = teng.draw_uniforms(w, params.r, params.p_j, gen, dev)
        nxt_k, hops_k = wt.walk_transition_ragged(nodes, *kargs, u, **kw)
        nxt_p, hops_p = walk_transition_ragged_ref(nodes, *kargs, u, **kw)
        c = compare_with_plain(nxt_k, hops_k, nxt_p, hops_p, u,
                               f"churned engine, hub walks {hub_walks}")
        out["kernel_vs_plain"].append({"hub_walks": hub_walks, **c})
        log(f"  (b) kernel vs plain on the churned buffers, W={w}, hub walks "
            f"{hub_walks}: bitwise outside {c['d_differs']} d differences "
            f"in {c['jumps']} jumps, max abs err {c['max_abs_err']}")
    v0 = torch.as_tensor(np.random.default_rng(3).integers(
        0, g2.n, w).astype(np.int32), device=dev)
    runs = {}
    for capture in (None, False):
        g_run = torch.Generator(device=dev).manual_seed(7)
        counts_zero(wt)
        with ScanLog() as sl:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            nodes, hops = e2.run(v0, P11_STEPS, generator=g_run,
                                 capture=capture)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
        runs[capture] = (nodes, hops, g_run.get_state(), dt, sl.stats[0],
                         counts_read(wt))
    (n_c, h_c, s_c, dt_c, st_c, l_c), (n_u, h_u, s_u, dt_u, _, _) = (
        runs[None], runs[False])
    if not (torch.equal(n_c, n_u) and torch.equal(h_c, h_u)
            and torch.equal(s_c, s_u)):
        raise AssertionError("churned engine: captured and uncaptured runs "
                             "differ")
    if l_c["walk_transition_ragged"] != P11_STEPS:
        raise AssertionError(f"churned engine run launched {l_c}")
    loop = scan_summary(st_c, dt_c)
    loop["uncaptured_ms_per_step"] = dt_u * 1e3 / P11_STEPS
    out.update(run=loop, launches_run=l_c)
    log(f"  (b) churned engine W={w} T={P11_STEPS}: captured "
        f"{loop['ms_per_step']:.5f} ms/step (replayed "
        f"{loop['replayed_ms_per_step']:.5f}; capture "
        f"{loop['capture_s']:.4f} s), uncaptured "
        f"{loop['uncaptured_ms_per_step']:.5f} ms/step; captured == "
        f"uncaptured bit for bit (walks, hops, generator)")
    # one post-churn step of fresh engines of every other layout
    t0 = time.perf_counter()
    g2c = g2.to_csr()
    u = teng.draw_uniforms(w, params.r, params.p_j, gen, dev)
    cur = n_c[:, -1].contiguous()
    ref_next, ref_hops = e2.step(cur, uniforms=u)
    out["layouts"] = {}
    for layout, extra in (("sparse", {}), ("dense", {}),
                          ("bucketed", {"compact": True})):
        e = teng.WalkEngine.from_graph(g2c, params, lipschitz=lips,
                                       layout=layout, device=dev, **extra)
        counts_zero(wt)
        nxt, hops = e.step(cur, uniforms=u)
        torch.cuda.synchronize()
        launches = counts_read(wt)
        if not (torch.equal(nxt, ref_next) and torch.equal(hops, ref_hops)):
            raise AssertionError(f"post-churn {layout} step differs from the "
                                 "ragged step")
        out["layouts"][layout] = launches
        del e
    log(f"  (b) one post-churn step of fresh sparse, dense and bucketed "
        f"engines == the churned ragged engine's, bit for bit "
        f"({time.perf_counter() - t0:.2f} s with their set-up); launches "
        f"{out['layouts']}")
    return out


def phase11_trainer(dev, wt, ttrain, params, batch) -> dict:
    """(c) phase 3's trainer across a churn: P11_TRAIN_STEPS steps, the
    batch of (a) applied to its graph (the trainer's row source, restricted
    to the touched rows), ``WalkFleet.migrate``, P11_TRAIN_STEPS more on
    the churned engine; each segment captured and uncaptured bit for
    bit."""
    import dataclasses

    from repro_torch.core.graphs import apply_edge_churn, barabasi_albert
    from repro_torch.core.transition import mh_importance_rows_ragged
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.models import regression as treg
    from repro_torch.walk_sgd import fleet as tfleet

    t0 = time.perf_counter()
    g = barabasi_albert(*CHURN_GRAPH, seed=0, layout="ragged")
    data = make_heterogeneous_regression(
        g.n, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
        x_star_scale=3.0)
    gamma = float(0.3 / data.lipschitz.mean())
    total = 2 * P11_TRAIN_STEPS
    rows, weights, sched, p_d, r, _ = ttrain._setup_method(
        "mhlj", g, data, params, None, total)
    eng = ttrain._build_engine(g, p_d, r, rows, None, dev)
    fleet = tfleet.WalkFleet.create(eng, FAULT_WALKS, seed=0,
                                    avg_every=FAULT_AVG)
    feats = torch.as_tensor(np.asarray(data.features, np.float32), device=dev)
    targs = torch.as_tensor(np.asarray(data.targets, np.float32), device=dev)
    w_t = torch.as_tensor(weights, device=dev)
    sched_t = torch.as_tensor(sched, device=dev)
    setup_s = time.perf_counter() - t0

    def segment(fl, xs, start, state, capture):
        gen = torch.Generator(device=dev)
        gen.set_state(state)
        with ScanLog() as sl:
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = tfleet.run_fleet(
                xs, feats, targs, w_t, fl, P11_TRAIN_STEPS, gamma,
                sched_t[start:start + P11_TRAIN_STEPS], True,
                treg.linear_grad, generator=gen, start_step=start,
                total_steps=total, capture=capture)
            torch.cuda.synchronize()
        return res, time.perf_counter() - t1, sl.stats[0], gen.get_state()

    def both(fl, xs, start, state, where):
        counts_zero(wt)
        cap = segment(fl, xs, start, state, None)
        launches = counts_read(wt)
        unc = segment(fl, xs, start, state, False)
        for i, name in enumerate(("models", "mse", "avg_mse", "update_nodes",
                                  "hops")):
            if not torch.equal(cap[0][i], unc[0][i]):
                raise AssertionError(f"{where}: captured and uncaptured "
                                     f"differ in {name}")
        if not (torch.equal(cap[0][5]["nodes"], unc[0][5]["nodes"])
                and torch.equal(cap[3], unc[3])):
            raise AssertionError(f"{where}: final nodes or generator differ")
        if launches["walk_transition_ragged"] != P11_TRAIN_STEPS:
            raise AssertionError(f"{where}: launched {launches}")
        loop = scan_summary(cap[2], cap[1])
        loop["uncaptured_ms_per_step"] = unc[1] * 1e3 / P11_TRAIN_STEPS
        return cap, loop, launches

    x0 = torch.zeros(FAULT_WALKS, data.dim, device=dev)
    state0 = torch.Generator(device=dev).manual_seed(0).get_state()
    a, loop_a, launch_a = both(fleet, x0, 0, state0, "trainer before churn")
    t1 = time.perf_counter()
    ins, dele = batch
    g2, churn = apply_edge_churn(g, insert=ins, delete=dele)
    need_full = g2.max_degree > eng.cdf_width
    e2 = eng.apply_churn(g2, churn, touched_probs=mh_importance_rows_ragged(
        g2, data.lipschitz, node_ids=None if need_full else churn.touched_rows))
    fleet2, displaced = dataclasses.replace(
        fleet, nodes=a[0][5]["nodes"]).migrate(e2, seed=7919)
    torch.cuda.synchronize()
    churn_s = time.perf_counter() - t1
    b, loop_b, launch_b = both(fleet2, a[0][0], P11_TRAIN_STEPS, a[3],
                               "trainer after churn")
    avg = torch.cat([a[0][2], b[0][2][1:]]).cpu().numpy()
    if not np.isfinite(avg).all():
        raise AssertionError("trainer across the churn: avg_mse not finite")
    log(f"  (c) trainer BA{CHURN_GRAPH} ragged W={FAULT_WALKS} across the "
        f"churn (set-up {setup_s:.2f} s): before {loop_a['replayed_ms_per_step']:.5f} "
        f"ms/step replayed, after {loop_b['replayed_ms_per_step']:.5f} "
        f"(re-capture {loop_b['capture_s']:.4f} s, before "
        f"{loop_a['capture_s']:.4f}); uncaptured {loop_a['uncaptured_ms_per_step']:.5f} "
        f"/ {loop_b['uncaptured_ms_per_step']:.5f}; churn + patch + migrate "
        f"{churn_s:.2f} s ({'full rebuild' if need_full else 'touched rows'}), "
        f"walks displaced {int(displaced.sum())}; avg_mse {avg[0]:.4f} -> "
        f"{avg[P11_TRAIN_STEPS]:.4f} -> {avg[-1]:.4f}; each segment captured "
        f"== uncaptured bit for bit")
    return {"setup_s": setup_s, "before": loop_a, "after": loop_b,
            "churn_s": churn_s, "escalated": bool(need_full),
            "displaced": int(displaced.sum()),
            "avg_mse": [float(avg[0]), float(avg[P11_TRAIN_STEPS]),
                        float(avg[-1])],
            "launches": [launch_a, launch_b]}


DADA_FIELDS = ("round_mse", "personalized_mse", "edges_inserted",
               "edges_deleted", "walks_displaced", "graph_versions",
               "x_final")


def engine_on(e, device):
    """A walk engine's copy on ``device`` (through its checkpoint)."""
    from repro_torch.walk_sgd import fleet as tfleet

    one = tfleet.WalkFleet(engine=e, nodes=torch.zeros(
        1, dtype=torch.int32, device=e.device), num_walks=1)
    return tfleet.WalkFleet.restore(one.checkpoint(), device=device).engine


def phase11_dada(dev, wt, teng) -> dict:
    """(d) ``run_dada`` at the Dada scale on the card: captured against
    ``capture=False`` bit for bit; a kill after round 2 and a resume from
    the checkpoint bit for bit; each round replayed on the CPU from the
    card's round-start state and blocks (update nodes, then the rewire
    from the card's personalized models: edges, patched CDF, displaced
    walks, graph version); the CPU's own run of the card's blocks
    equal to the card's run (edges, every round's kNN edge set, displaced
    walks, graph versions, update nodes); wall seconds per round of each
    part."""
    import tempfile

    from repro_torch.core.graphs import barabasi_albert
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import fleet as tfleet
    from repro_torch.walk_sgd import graph_learning as gl

    g = barabasi_albert(DADA_N, 3, seed=0, layout="ragged")
    data = make_heterogeneous_regression(
        DADA_N, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
        x_star_scale=3.0)
    lips = np.asarray(data.lipschitz, np.float64)
    parts = ("_walk_round", "personalize_models", "similarity_edges",
             "_rewire")
    saved = {p: getattr(gl, p) for p in parts}
    times = {p: [] for p in parts}
    seen = {p: [] for p in parts}

    def timed(name):
        def run(*a, **k):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = saved[name](*a, **k)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            seen[name].append((a, k, out))
            return out
        return run

    def dada(**kw):
        for p in parts:
            times[p].clear()
            seen[p].clear()
            setattr(gl, p, timed(p))
        try:
            return gl.run_dada(g, data, **DADA_KW, **kw)
        finally:
            for p in parts:
                setattr(gl, p, saved[p])

    counts_zero(wt)
    t0 = time.perf_counter()
    cap = dada(device=dev)
    cap_s = time.perf_counter() - t0
    launches = counts_read(wt)
    per_round = {p: list(times[p]) for p in parts}
    card = {p: list(seen[p]) for p in parts}
    rounds, steps = DADA_KW["rounds"], DADA_KW["num_steps"]
    if launches["walk_transition_ragged"] != rounds * steps:
        raise AssertionError(f"run_dada launched {launches}")
    t0 = time.perf_counter()
    unc = dada(device=dev, capture=False)
    unc_s = time.perf_counter() - t0

    def same(a, b, where):
        for f in DADA_FIELDS:
            if not np.array_equal(getattr(a, f), getattr(b, f)):
                raise AssertionError(f"run_dada {where}: {f} differs")

    same(cap, unc, "captured vs uncaptured")
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "dada.npz")
        calls = []

        def dying(**k):
            if len(calls) == 2:
                raise KeyboardInterrupt("killed after round 2")
            calls.append(1)
            return saved["_walk_round"](**k)

        gl._walk_round = dying
        try:
            gl.run_dada(g, data, **DADA_KW, device=dev, checkpoint_path=path)
        except KeyboardInterrupt:
            pass
        finally:
            gl._walk_round = saved["_walk_round"]
        _, killed_at, _ = tfleet.load_fleet_checkpoint(path, device="cpu")
        resumed = gl.run_dada(g, data, **DADA_KW, device=dev,
                              checkpoint_path=path)
    if killed_at != 2:
        raise AssertionError(f"the killed run's checkpoint is at {killed_at}")
    same(cap, resumed, "killed after round 2 and resumed")
    # the card's per-round streams, drawn again step by step as run_fleet
    # draws them
    blocks = []
    p_j = torch.full((1,), np.float32(0.1), device=dev)
    for rnd in range(rounds):
        gen = torch.Generator(device=dev).manual_seed(DADA_KW["seed"] + rnd)
        blocks.append(torch.stack([
            teng.draw_uniforms(DADA_KW["num_walks"], 3, p_j, gen, dev)
            for _ in range(steps)]).cpu())
    # each round on the CPU from the card's round-start state
    t0 = time.perf_counter()
    for rnd, (_, kw, res) in enumerate(card["_walk_round"]):
        kw = dict(kw, device=torch.device("cpu"), uniforms=blocks[rnd],
                  generator=None, capture=None,
                  engine=engine_on(kw["engine"], "cpu"))
        cpu_res = saved["_walk_round"](**kw)
        if not np.array_equal(cpu_res.update_nodes, res.update_nodes):
            raise AssertionError(f"run_dada round {rnd}: the CPU's update "
                                 "nodes differ from the card's")
        if rnd == rounds - 1:
            break
        (core, e_card, desired, _), _, out = card["_rewire"][rnd]
        core2, e2, n_ins, n_del = saved["_rewire"](
            core, engine_on(e_card, "cpu"), desired, lips)
        if (n_ins, n_del) != (int(cap.edges_inserted[rnd]),
                              int(cap.edges_deleted[rnd])):
            raise AssertionError(f"run_dada round {rnd}: CPU rewire "
                                 f"{(n_ins, n_del)}")
        if not (same_bits(e2.edge_cdf, out[1].edge_cdf)
                and e2.graph_version == out[1].graph_version
                == cap.graph_versions[rnd + 1]):
            raise AssertionError(f"run_dada round {rnd}: the CPU's patched "
                                 "engine differs from the card's")
        _, displaced = tfleet.migrate_walk_nodes(
            res.update_nodes[:, -1], core2.degrees,
            seed=DADA_KW["seed"] + 7919 * (rnd + 1))
        if int(displaced.sum()) != int(cap.walks_displaced[rnd + 1]):
            raise AssertionError(f"run_dada round {rnd}: displaced walks")
    replay_s = time.perf_counter() - t0
    # the CPU's own run on the card's blocks: its models follow its own
    # float32 reductions (a few ulps off the card's), and the kNN at this
    # scale is ill-conditioned, so equal edges also say no near tie flipped
    card_models = [o for _, _, o in card["personalize_models"]]
    t0 = time.perf_counter()
    free = dada(device="cpu", uniforms=blocks)
    free_s = time.perf_counter() - t0
    free_models = [o for _, _, o in seen["personalize_models"]]
    free_same = {f: bool(np.array_equal(getattr(cap, f), getattr(free, f)))
                 for f in ("edges_inserted", "edges_deleted",
                           "walks_displaced", "graph_versions")}
    free_same["update_nodes"] = all(
        np.array_equal(a[2].update_nodes, b[2].update_nodes)
        for a, b in zip(card["_walk_round"], seen["_walk_round"]))
    free_same["rewires"] = all(
        np.array_equal(a[0][2], b[0][2])
        for a, b in zip(card["_rewire"], seen["_rewire"]))
    if not all(free_same.values()):
        raise AssertionError(f"run_dada: the CPU's run of the card's blocks "
                             f"differs from the card's: {free_same}")
    models0 = float(np.max(np.abs(card_models[0] - free_models[0])))
    mse_rel = float(np.max(np.abs(cap.round_mse - free.round_mse)
                           / np.abs(free.round_mse)))
    gaps, scale = [], []
    for x in card_models[:-1]:
        x = np.asarray(x, np.float64)
        sq = (x * x).sum(axis=1)
        d2 = sq[:, None] + sq[None, :] - 2.0 * (x @ x.T)
        np.fill_diagonal(d2, np.inf)
        srt = np.sort(d2, axis=1)
        k = DADA_KW["k"]
        gaps.append(float(np.min(srt[:, k] - srt[:, k - 1])))
        scale.append(float(np.median(srt[:, k - 1])))
    for rnd in range(rounds):
        log(f"  (d) run_dada round {rnd}: walk "
            f"{per_round['_walk_round'][rnd]:.3f} s, personalize "
            f"{per_round['personalize_models'][rnd]:.4f} s"
            + (f", similarity {per_round['similarity_edges'][rnd]:.3f} s, "
               f"churn {per_round['_rewire'][rnd]:.3f} s; inserted "
               f"{cap.edges_inserted[rnd]}, deleted {cap.edges_deleted[rnd]}"
               if rnd < rounds - 1 else "")
            + f"; displaced entering {cap.walks_displaced[rnd]}, graph "
            f"version {cap.graph_versions[rnd]}, round_mse "
            f"{cap.round_mse[rnd]:.6g}")
    log(f"  (d) run_dada BA({DADA_N},3) rounds {rounds} x {steps} steps W="
        f"{DADA_KW['num_walks']}: {cap_s:.2f} s captured, {unc_s:.2f} s "
        f"uncaptured, equal bit for bit; killed after round 2 and resumed: "
        f"equal; each round on the CPU from the card's state and blocks "
        f"({replay_s:.2f} s): update nodes, rewire, patched CDF, displaced "
        f"walks and graph versions equal")
    log(f"  (d) the CPU's own run of the card's blocks ({free_s:.2f} s): "
        f"equal to the card's {free_same}; round-0 personalized models max "
        f"|d| {models0:.3g}, round_mse max rel diff {mse_rel:.3g}; smallest "
        f"k-th/(k+1)-th kNN gap per rewire {gaps} against a median k-th "
        f"squared distance {scale}")
    return {"captured_s": cap_s, "uncaptured_s": unc_s,
            "cpu_replay_s": replay_s, "per_round_s": per_round,
            "launches": launches, "round_mse": cap.round_mse.tolist(),
            "edges_inserted": cap.edges_inserted.tolist(),
            "edges_deleted": cap.edges_deleted.tolist(),
            "walks_displaced": cap.walks_displaced.tolist(),
            "free_run_equal": free_same, "free_run_s": free_s,
            "round0_models_max_abs": models0,
            "round_mse_free_max_rel": mse_rel, "knn_gaps": gaps,
            "knn_median_d2": scale}


def phase11_sampling(dev) -> dict:
    """(e) ``core.torch_sampling`` on the card: BA(100k,3) edges and an SBM
    4x250 from injected uniforms equal the CPU's bit for bit; a BA graph
    from the card's generator is valid."""
    from repro_torch.core import torch_sampling as ts

    n, m = CHURN_GRAPH
    gen = torch.Generator().manual_seed(0)
    u = torch.rand(m * (n - m), generator=gen)
    out = {}
    for d in (dev, "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        edges = ts.barabasi_albert_edges(n, m, uniforms=u, device=d)
        torch.cuda.synchronize()
        out[str(d)] = (edges, time.perf_counter() - t0)
    card, cpu = out[str(dev)], out["cpu"]
    if not all(torch.equal(a.cpu(), b) for a, b in zip(card[0], cpu[0])):
        raise AssertionError("BA edges on the card differ from the CPU's")
    pairs = sum(SBM_SIZES) * (sum(SBM_SIZES) - 1) // 2
    us = [torch.rand(pairs, generator=gen) for _ in range(8)]
    sbm = {}
    for d in (dev, "cpu"):
        t0 = time.perf_counter()
        sbm[str(d)] = (ts.sbm_torch(SBM_SIZES, *SBM_P, uniforms=us, device=d,
                                    layout="ragged"),
                       time.perf_counter() - t0)
    for f in ("indptr", "indices", "degrees"):
        if not np.array_equal(getattr(sbm[str(dev)][0], f),
                              getattr(sbm["cpu"][0], f)):
            raise AssertionError(f"SBM on the card differs from the CPU in {f}")
    t0 = time.perf_counter()
    drawn = ts.barabasi_albert_torch(
        n, m, generator=torch.Generator(device=dev).manual_seed(1),
        layout="ragged", device=dev)
    drawn_s = time.perf_counter() - t0
    log(f"  (e) torch_sampling: BA({n},{m}) edges card {card[1]:.4f} s, CPU "
        f"{cpu[1]:.4f} s, equal; SBM {len(SBM_SIZES)}x{SBM_SIZES[0]} card "
        f"{sbm[str(dev)][1]:.4f} s, CPU {sbm['cpu'][1]:.4f} s, equal; a BA "
        f"graph from the card's generator: valid, max degree "
        f"{drawn.max_degree}, {drawn_s:.3f} s with from_edges")
    return {"ba_card_s": card[1], "ba_cpu_s": cpu[1],
            "sbm_card_s": sbm[str(dev)][1], "sbm_cpu_s": sbm["cpu"][1],
            "ba_generator_s": drawn_s, "ba_generator_max_degree":
            drawn.max_degree}


def phase_dynamic_graphs(dev, smi) -> dict:
    """Phase 11: dynamic graphs on the card."""
    from repro_torch.core import engine as teng
    from repro_torch.core.transition import MHLJParams
    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.walk_sgd import trainer as ttrain

    params = MHLJParams(0.1, 0.5, 3)
    log(f"phase 11 (dynamic graphs): {smi}; aim {PHASE11_AIM_S:.0f} s")
    out: dict = {}
    marks = [time.perf_counter()]
    sweep = phase11_churn_sweep(dev, params)
    out["churn_sweep"] = sweep["out"]
    marks.append(time.perf_counter())
    out["walks"] = phase11_walks(dev, wt, teng, params, sweep["g2"],
                                 sweep["engine"], sweep["lips"])
    del sweep["engine"]
    marks.append(time.perf_counter())
    out["trainer"] = phase11_trainer(dev, wt, ttrain, params, sweep["batch"])
    marks.append(time.perf_counter())
    out["dada"] = phase11_dada(dev, wt, teng)
    marks.append(time.perf_counter())
    out["sampling"] = phase11_sampling(dev)
    marks.append(time.perf_counter())
    out["part_s"] = dict(zip("abcde", np.diff(marks).tolist()))
    log("  phase 11 parts: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in out["part_s"].items()))
    return out


T_START = time.perf_counter()


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; nothing to run", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.core import engine as teng
    from repro_torch.core.graphs import barabasi_albert, ring
    from repro_torch.core.levy import trunc_geom_icdf
    from repro_torch.core.transition import MHLJParams, mh_importance_rows_ragged
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.kernels import _build
    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.kernels.walk_transition.ref import walk_transition_ragged_ref
    from repro_torch import interop
    from repro_torch.walk_sgd import run_rw_sgd_multi
    from repro_torch.walk_sgd import trainer as ttrain

    here = os.path.join(ROOT, "src", "repro_torch")
    if os.path.dirname(os.path.abspath(repro_torch.__file__)) != here:
        raise RuntimeError(f"repro_torch imported from {repro_torch.__file__}, "
                           f"not from this checkout ({here})")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(smi)  # the card, exactly as nvidia-smi reports it
    log(f"torch {torch.__version__} cuda {torch.version.cuda} python "
        f"{sys.version.split()[0]}")
    report: dict = {"card": smi, "phases": {}}

    # -- build ------------------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = _build.build()
    dt = time.perf_counter() - t0
    for name, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "arning",
                                       "setmaxnreg", "wgmma")):
                log(f"  nvcc {name}: {line.strip()}")
            if (name.startswith("walk_transition")
                    and "spill" in line and not line.strip().endswith(
                        "0 bytes spill stores, 0 bytes spill loads")):
                raise AssertionError(f"{name} spills: {line.strip()}")
    hgmma = sass_count("flash_attention_wgmma", "HGMMA")
    log(f"  cuobjdump -sass flash_attention_wgmma: {hgmma} HGMMA instructions")
    if hgmma == 0:
        raise AssertionError("the bf16 flash_attention library has no HGMMA")
    # HMMA (mma.sync) or HGMMA (wgmma): the bf16 SSD scan on the tensor cores
    ssd_mma = sass_count("ssd_scan_mma", "HMMA") + sass_count("ssd_scan_mma", "HGMMA")
    log(f"  cuobjdump -sass ssd_scan_mma: {ssd_mma} HMMA/HGMMA instructions")
    if ssd_mma == 0:
        raise AssertionError("the bf16 ssd_scan library has no HMMA or HGMMA")
    log(f"phase build: {len(_build.SOURCES)} kernel source(s), "
        f"{len(build_logs)} compiled, {dt:.2f} s")
    report["phases"]["build_s"] = dt
    report["phases"]["hgmma"] = hgmma
    report["phases"]["ssd_hmma"] = ssd_mma

    # -- phase 1: kernel vs plain version on the card -----------------------------
    t0 = time.perf_counter()
    g = barabasi_albert(1_000_000, 3, seed=0, layout="ragged")
    t_graph = time.perf_counter() - t0
    lips = np.exp(np.random.default_rng(11).normal(0.0, 1.0, g.n))
    params = MHLJParams(0.1, 0.5, 3)
    t1 = time.perf_counter()
    eng = teng.WalkEngine.from_graph(g, params, lipschitz=lips, device=dev)
    torch.cuda.synchronize()
    t_cdf = time.perf_counter() - t1
    log(f"  graph BA(1M,3): n={g.n} nnz={g.num_edges} max_deg={g.max_degree} "
        f"host build {t_graph:.2f} s, device CDF build {t_cdf:.2f} s")
    gen = torch.Generator(device=dev)
    gen.manual_seed(1234)
    phase1 = []
    # (W, r, p_J, walks on the hub): W/16+1 hub walks, or every walk there
    for w, r, p_j, hub in ((8192, 3, params.p_j, 8192 // 16 + 1),
                           (257, 1, 0.5, 257 // 16 + 1),
                           (257, 5, 0.5, 257 // 16 + 1),
                           (8192, 3, 0.0, 8192 // 16 + 1),
                           (8192, 3, 1.0, 8192 // 16 + 1),
                           (8192, 3, params.p_j, 8192)):
        nodes = torch.randint(0, g.n, (w,), generator=gen, device=dev,
                              dtype=torch.int32)
        nodes[:hub] = int(np.argmax(g.degrees))
        u = teng.draw_uniforms(w, r, p_j, gen, dev)
        args = (nodes, eng.indptr, eng.degrees, eng.indices, eng.edge_cdf, u)
        kw = dict(p_d=params.p_d, r=r, max_degree=eng.max_degree)
        nxt_k, hops_k = wt.walk_transition_ragged(*args, **kw)
        nxt_p, hops_p = walk_transition_ragged_ref(*args, **kw)
        c = compare_with_plain(nxt_k, hops_k, nxt_p, hops_p, u,
                               f"at W={w} r={r} p_J={p_j} hub walks {hub}")
        phase1.append({"w": w, "r": r, "p_j": p_j, "hub_walks": hub, **c})
        log(f"  kernel vs plain W={w} r={r} p_J={p_j} hub walks {hub}: "
            f"bitwise on {w - c['d_differs']}/{w} walks, d differs on "
            f"{c['d_differs']} of {c['jumps']} jumps, max abs err "
            f"{c['max_abs_err']}")
    # d agreement sweep: every walk jumps, so hops == d
    sweep = {}
    m = 1_000_000
    for p_d, r in ((0.5, 3), (0.1, 10), (0.3, 5), (0.5, 1), (0.05, 16)):
        u = torch.rand((m, teng.num_uniforms(r)), generator=gen, device=dev)
        u[:, 0] = 1.0
        zeros = torch.zeros(m, dtype=torch.int32, device=dev)
        _, d_k = wt.walk_transition_ragged(
            zeros, eng.indptr, eng.degrees, eng.indices, eng.edge_cdf, u,
            p_d=p_d, r=r, max_degree=eng.max_degree,
        )
        d_gpu = trunc_geom_icdf(u[:, 2], p_d, r)
        d_cpu = trunc_geom_icdf(u[:, 2].cpu(), p_d, r)
        k_vs_gpu = int((d_k != d_gpu).sum())
        k_vs_cpu = int((d_k.cpu() != d_cpu).sum())
        sweep[f"{p_d},{r}"] = {"kernel_vs_torch_cuda": k_vs_gpu,
                               "kernel_vs_torch_cpu": k_vs_cpu, "draws": m}
        log(f"  d sweep p_d={p_d} r={r}: kernel vs torch-cuda {k_vs_gpu}/{m}, "
            f"kernel vs torch-cpu {k_vs_cpu}/{m}")
        if k_vs_cpu > 10 * (m // 1_000_000):
            raise AssertionError("d agreement below 1 - 1e-5")
    dt = time.perf_counter() - t0
    log(f"phase 1 kernel-vs-plain: {dt:.2f} s")
    report["phases"]["kernel_vs_plain"] = {"s": dt, "cases": phase1,
                                           "d_sweep": sweep,
                                           "graph_build_s": t_graph,
                                           "cdf_build_s": t_cdf}

    # -- phase 2: engine on the card --------------------------------------------
    t0 = time.perf_counter()
    w, steps = 8192, 200
    v0 = torch.as_tensor(
        np.random.default_rng(3).integers(0, g.n, w).astype(np.int32),
        device=dev,
    )
    gen.manual_seed(99)
    eng.run(v0, 5, generator=gen)  # warm
    torch.cuda.synchronize()
    counters = {"walk_transition_sparse": wt.walk_transition_sparse,
                "walk_transition": wt.walk_transition,
                "walk_transition_ragged": wt.walk_transition_ragged}
    loop2 = engine_loop(
        eng, v0, steps, 7, dev, counters,
        {k: steps if k == "walk_transition_ragged" else 0 for k in counters},
        KERNEL_SYMBOL["walk_transition_ragged"], f"engine ragged W={w}")
    update_nodes, hops = loop2["nodes"], loop2["hops"]
    launches = loop2["loop"]["launches"]
    run_ms = loop2["loop"]["ms_per_step"] * steps
    rate = w * steps / (run_ms / 1e3)
    # replay the run's exact kernel inputs: same generator stream, same nodes
    gen.manual_seed(7)
    blocks = [teng.draw_uniforms(w, params.r, params.p_j, gen, dev)
              for _ in range(steps)]
    cur = [update_nodes[:, t].contiguous() for t in range(steps)]
    kargs = (eng.indptr, eng.degrees, eng.indices, eng.edge_cdf)
    kw = dict(p_d=params.p_d, r=params.r, max_degree=eng.max_degree)
    for t in range(steps - 1):
        nxt, _ = wt.walk_transition_ragged(cur[t], *kargs, blocks[t], **kw)
        if not torch.equal(nxt, cur[t + 1]):
            raise AssertionError(f"replay of step {t} does not reproduce the run")
    kernel_t = events_and_cupti(
        lambda i: wt.walk_transition_ragged(cur[i], *kargs, blocks[i], **kw),
        steps, KERNEL_SYMBOL["walk_transition_ragged"])
    kernel_ms, kernel_host_ms = kernel_t["events_ms"], kernel_t["host_ms"]
    plain_ms, plain_host_ms, plain_chunk = device_time_ms(
        lambda i: walk_transition_ragged_ref(cur[i], *kargs, blocks[i], **kw),
        50,
    )
    gen.manual_seed(7)
    prof = profile_window(
        lambda: eng.run(v0, 50, generator=gen, capture=False),
        KERNEL_SYMBOL["walk_transition_ragged"])
    nbytes = nops = 0
    for t in range(steps):
        b, o = bound_for_step(cur[t], eng.indptr, eng.degrees, eng.indices,
                              eng.edge_cdf, blocks[t], params.r, params.p_d,
                              eng.max_degree)
        nbytes += b
        nops += o
    bytes_ms = nbytes / steps / HBM_BYTES_PER_S * 1e3
    ops_ms = nops / steps / FP32_OPS_PER_S * 1e3
    bound_ms = max(bytes_ms, ops_ms)
    hops_mean = float(hops.double().mean())
    engine_digest = check_digest(
        "engine", digest(update_nodes.cpu().numpy(), hops.cpu().numpy()))
    # what the kernel's time is made of: the floor of a launch, the latency
    # of a dependent load, the chain bound, the p_J split, the group widths
    floor_t = launch_floor(dev)
    log(f"  launch floor, one-element add_: {fmt_ms(floor_t)}")
    slope = hop_slope(wt, teng, kargs, g.n, params.p_d, eng.max_degree, gen,
                      dev)
    latency_ms = slope["load_latency_cupti_ms"] or slope["load_latency_events_ms"]
    log("  hop slope BA(1M,3), W=132, d = r: " + "; ".join(
        f"r={r} {fmt_ms(t)}" for r, t in slope["per_r"].items())
        + f"; one dependent load {slope['load_latency_events_ms']} ms by "
        f"events, {slope['load_latency_cupti_ms']} ms by CUPTI")
    chains = [chain_loads(u, params.p_d, params.r) for u in blocks]
    chain_ms = float(np.mean(chains)) * latency_ms
    log(f"  chain bound of the run's blocks: {float(np.mean(chains)):.3f} "
        f"loads a launch (longest {max(chains)}) x {latency_ms:.3e} ms = "
        f"{chain_ms:.6f} ms; bytes bound {bound_ms:.6f} ms")
    study = ragged_study(wt, teng, kargs, cur, params.p_d, params.r,
                         eng.max_degree, gen, dev, latency_ms,
                         "W=8192 BA(1M,3)")
    dt = time.perf_counter() - t0
    log(f"  engine run W={w} T={steps}: {launches} launches, "
        f"{rate:.4e} walk-steps/s ({run_ms / steps:.4f} ms/step), "
        f"hops/update {hops_mean:.4f}, walks' digest {engine_digest}")
    log(f"  kernel {kernel_ms:.5f} ms/launch back to back on the device "
        f"(held in chunks of {kernel_t['held_chunk']}; CUPTI "
        f"{kernel_t['cupti_ms']} ms; host enqueue {kernel_host_ms:.5f} "
        f"ms/call), plain {plain_ms:.5f} ms (held in chunks of {plain_chunk}; "
        f"host {plain_host_ms:.5f} ms/call), "
        f"bound {bound_ms:.6f} ms ({nbytes / steps:.0f} B/step over HBM; "
        f"ops bound {ops_ms:.2e} ms)")
    if prof["window_ms"] is None:
        log("  profiler: no device activity recorded; idle share not measured")
    else:
        log(f"  profiler, 50-step uncaptured run: window "
            f"{prof['window_ms']:.4f} ms, device busy {prof['busy_ms']:.4f} "
            f"ms, idle share {prof['idle_share']:.4f}, kernel "
            f"{prof['kernel_ms']} ms/launch over {prof['kernel_launches']} "
            f"launches")
    log(f"phase 2 engine: {dt:.2f} s")
    report["phases"]["engine"] = {
        "s": dt, "w": w, "steps": steps, "launches": launches,
        "run_ms": run_ms, "walk_steps_per_s": rate, "kernel_ms": kernel_ms,
        "kernel_host_ms": kernel_host_ms, "kernel_timing": kernel_t,
        "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
        "plain_held_chunk": plain_chunk, "bound_ms": bound_ms, "bytes_per_step":
        nbytes / steps, "ops_per_step": nops / steps, "hops_mean": hops_mean,
        "profile_50_steps": prof, "walks_digest": engine_digest,
        "loop": loop2["loop"],
        "launch_floor": floor_t, "hop_slope": slope,
        "chain_loads_max": max(chains), "chain_bound_ms": chain_ms,
        "study": study,
    }
    del blocks, cur, eng, g

    # -- phase 3: trainer on the card -------------------------------------------
    t0 = time.perf_counter()
    g3 = barabasi_albert(100_000, 3, seed=0, layout="ragged")
    data = make_heterogeneous_regression(
        100_000, dim=6, sigma_high_sq=100.0, p_high=0.03, seed=7,
        x_star_scale=3.0,
    )
    gamma = float(0.3 / data.lipschitz.mean())
    steps3, w3 = 500, 2048
    # time the set-up and the training loop apart, and keep the fleet and
    # the generator's starting state so every step's kernel inputs can be
    # replayed exactly; the wrapped function runs unchanged
    wt.walk_transition_ragged.launches = 0
    res, seen = timed_training(
        ttrain, "mhlj", g3, data, gamma, steps3, w3, mhlj_params=params,
        avg_every=50, seed=0, device=dev,
    )
    train_launches = wt.walk_transition_ragged.launches
    t_setup, t_loop, t_train = seen["setup_s"], seen["loop_s"], seen["train_s"]
    ragged_nodes = res.update_nodes
    if train_launches != steps3:
        raise AssertionError(f"trainer launched the kernel {train_launches} "
                             f"times in {steps3} steps")
    avg = res.avg_mse
    if res.mse.shape != (w3, steps3 + 1) or avg.shape != (steps3 + 1,):
        raise AssertionError("trainer traces have the wrong shape")
    if not (np.isfinite(res.mse).all() and np.isfinite(avg).all()):
        raise AssertionError("trainer produced non-finite MSE")
    if not avg[-1] < avg[0]:
        raise AssertionError(f"avg_mse did not fall: {avg[0]} -> {avg[-1]}")
    floor = data.mse(data.optimum())
    trainer_digest = digest(res.update_nodes, res.transitions)
    log(f"  trainer mhlj BA(100k,3) W={w3} T={steps3}: {train_launches} "
        f"launches, avg_mse {avg[0]:.4f} -> {avg[steps3 // 2]:.4f} -> "
        f"{avg[-1]:.4f} (least-squares floor {floor:.4f}), "
        f"hops/update {res.transitions_per_update:.4f}, {t_train:.2f} s "
        f"(set-up: P_IS rows on the host and CDF on the device "
        f"{t_setup:.2f} s; loop {t_loop / steps3 * 1e3:.4f} ms/step), "
        f"walks' digest {check_digest('trainer', trainer_digest)}")
    loop3 = trainer_loop_check(ttrain, res, seen, f"trainer ragged W={w3}")
    # replay every step of the run with its exact inputs (the trainer's
    # engine, the node vector, the block regenerated from the generator's
    # starting state): the kernel must reproduce the run, and its plain
    # version must agree outside d differences
    e3 = seen["fleet"].engine
    g_rep = torch.Generator(device=dev)
    g_rep.set_state(seen["gen_state"])
    nodes3 = torch.as_tensor(res.update_nodes, device=dev)
    hops3 = torch.as_tensor(res.transitions, device=dev)
    kargs3 = (e3.indptr, e3.degrees, e3.indices, e3.edge_cdf)
    kw3 = dict(p_d=e3.p_d, r=e3.r, max_degree=e3.max_degree)
    replay = {"steps": steps3, "walks": 0, "jumps": 0, "d_differs": 0,
              "max_abs_err": 0}
    blocks3, cur3 = [], []
    for t in range(steps3):
        u = teng.draw_uniforms(w3, e3.r, seen["p_j_sched"][t], g_rep, dev)
        cur = nodes3[:, t].contiguous()
        blocks3.append(u)
        cur3.append(cur)
        nxt_k, hops_k = wt.walk_transition_ragged(cur, *kargs3, u, **kw3)
        if not torch.equal(hops_k, hops3[:, t]) or (
            t + 1 < steps3 and not torch.equal(nxt_k, nodes3[:, t + 1])
        ):
            raise AssertionError(f"replay of trainer step {t} does not "
                                 "reproduce the run")
        nxt_p, hops_p = walk_transition_ragged_ref(cur, *kargs3, u, **kw3)
        c = compare_with_plain(nxt_k, hops_k, nxt_p, hops_p, u,
                               f"at trainer step {t}")
        for k in ("walks", "jumps", "d_differs"):
            replay[k] += c[k]
        replay["max_abs_err"] = max(replay["max_abs_err"], c["max_abs_err"])
    log(f"  trainer replay, {steps3} steps x W={w3} (max_deg "
        f"{e3.max_degree}, {teng.search_iters(e3.max_degree)} probes): "
        f"kernel reproduces the run; kernel vs plain bitwise outside "
        f"{replay['d_differs']} d differences in {replay['jumps']} jumps, "
        f"max abs err {replay['max_abs_err']}")
    del seen
    # the kernel on the trainer's own inputs, as in phase 2
    train_t = events_and_cupti(
        lambda i: wt.walk_transition_ragged(cur3[i], *kargs3, blocks3[i], **kw3),
        steps3, KERNEL_SYMBOL["walk_transition_ragged"])
    train_plain_ms, _, _ = device_time_ms(
        lambda i: walk_transition_ragged_ref(cur3[i], *kargs3, blocks3[i], **kw3),
        50)
    nbytes3 = sum(bound_for_step(cur3[t], *kargs3, blocks3[t], e3.r, e3.p_d,
                                 e3.max_degree)[0] for t in range(steps3))
    train_bound_ms = nbytes3 / steps3 / HBM_BYTES_PER_S * 1e3
    slope3 = hop_slope(wt, teng, kargs3, g3.n, e3.p_d, e3.max_degree, g_rep,
                       dev)
    latency3 = slope3["load_latency_cupti_ms"] or slope3["load_latency_events_ms"]
    chains3 = [chain_loads(u, e3.p_d, e3.r) for u in blocks3]
    chain3_ms = float(np.mean(chains3)) * latency3
    log(f"  kernel on the trainer's inputs (W={w3}, BA(100k,3), {steps3} "
        f"launches): {fmt_ms(train_t)}; plain {train_plain_ms:.5f} ms; bytes "
        f"bound {train_bound_ms:.6f} ms; hop slope: one dependent load "
        f"{slope3['load_latency_events_ms']} ms by events, "
        f"{slope3['load_latency_cupti_ms']} ms by CUPTI; chain bound "
        f"{float(np.mean(chains3)):.3f} loads (longest {max(chains3)}) = "
        f"{chain3_ms:.6f} ms")
    study3 = ragged_study(wt, teng, kargs3, cur3, e3.p_d, e3.r, e3.max_degree,
                          g_rep, dev, latency3, f"W={w3} BA(100k,3)")
    del blocks3, cur3
    # small input: the trainer on the card against its CPU run, same CDF
    # and same injected blocks
    gs = ring(64, layout="ragged")
    ds = make_heterogeneous_regression(64, dim=6, sigma_high_sq=100.0,
                                       p_high=0.03, seed=7, x_star_scale=3.0)
    rows = mh_importance_rows_ragged(gs, ds.lipschitz)
    cpu_eng = teng.WalkEngine.from_graph(gs, MHLJParams(0.0, 0.5, 3),
                                         row_probs=rows, device="cpu")
    state = dict(indptr=gs.indptr, indices=gs.indices, degrees=gs.degrees,
                 edge_cdf=cpu_eng.edge_cdf.numpy(), max_degree=cpu_eng.max_degree,
                 cdf_width=cpu_eng.max_degree, p_d=0.5, r=3)
    gpu_eng, _, _ = interop.from_reference_state(**state, device=dev)
    cpu_gen = torch.Generator().manual_seed(5)
    blocks = torch.stack([teng.draw_uniforms(8, 3, 0.3, cpu_gen,
                                             torch.device("cpu"))
                          for _ in range(200)])
    d_gpu = trunc_geom_icdf(blocks[..., 2].to(dev), 0.5, 3).cpu()
    d_cpu = trunc_geom_icdf(blocks[..., 2], 0.5, 3)
    if bool(((d_gpu != d_cpu) & (blocks[..., 0] > 0.5)).any()):
        raise AssertionError("small-input blocks hit a d difference; reseed")
    small = {}
    for name, e in (("cpu", cpu_eng), ("gpu", gpu_eng)):
        small[name] = run_rw_sgd_multi(
            "mhlj", gs, ds, float(0.3 / ds.lipschitz.mean()), 200, 8,
            mhlj_params=MHLJParams(0.3, 0.5, 3), avg_every=5, seed=0,
            engine=e, uniforms=blocks, device=e.device,
        )
    if not np.array_equal(small["cpu"].update_nodes, small["gpu"].update_nodes):
        raise AssertionError("trainer on the card walks differently from CPU")
    np.testing.assert_allclose(small["gpu"].avg_mse, small["cpu"].avg_mse,
                               rtol=1e-4)
    np.testing.assert_allclose(small["gpu"].mse, small["cpu"].mse, rtol=1e-4)
    dt = time.perf_counter() - t0
    log("  trainer small input: card == CPU (update nodes bitwise, MSE "
        "traces within rtol 1e-4)")
    log(f"phase 3 trainer: {dt:.2f} s")
    report["phases"]["trainer"] = {
        "s": dt, "train_s": t_train, "setup_s": t_setup, "loop_s": t_loop,
        "loop_ms_per_step": t_loop / steps3 * 1e3,
        "launches": train_launches, "replay": replay,
        "avg_mse_first": float(avg[0]), "avg_mse_mid": float(avg[steps3 // 2]),
        "avg_mse_last": float(avg[-1]), "floor": float(floor),
        "hops_per_update": res.transitions_per_update,
        "walks_digest": trainer_digest,
        "loop": loop3, "kernel": train_t, "plain_ms": train_plain_ms,
        "bound_ms": train_bound_ms, "hop_slope": slope3,
        "chain_loads_max": max(chains3), "chain_bound_ms": chain3_ms,
        "study": study3,
    }

    # -- phase 4: the padded and bucketed layouts on the card -------------------
    t0 = time.perf_counter()
    p4 = phase_layouts(dev, params)
    g4 = p4.pop("graph")
    dt = time.perf_counter() - t0
    log(f"phase 4 layouts: {dt:.2f} s")
    report["phases"]["layouts"] = {"s": dt, **p4}

    # -- phase 5: the trainer on the padded and bucketed layouts ---------------
    t0 = time.perf_counter()
    p5 = phase_layout_trainers(ttrain, g4, data, gamma, params, dev,
                               ragged_nodes)
    dt = time.perf_counter() - t0
    log(f"phase 5 layout trainers: {dt:.2f} s")
    report["phases"]["layout_trainers"] = {"s": dt, **p5}

    # -- phases 6-8: the LLM slice at full width ------------------------------
    t0 = time.perf_counter()
    p6 = phase_llm(dev)
    dt = time.perf_counter() - t0
    log(f"phases 6-8 LLM: {dt:.2f} s")
    report["phases"]["llm"] = {"s": dt, **p6}

    # -- phase 9: the paper's reproduction on the card -----------------------
    t0 = time.perf_counter()
    p9 = phase_paper(dev, smi)
    dt = time.perf_counter() - t0
    log(f"phase 9 paper: {dt:.2f} s")
    report["phases"]["paper"] = {"s": dt, **p9}

    # -- phase 10: the other chain laws and the fault path ------------------
    t0 = time.perf_counter()
    p10 = phase_laws_faults(dev, smi, p9)
    dt = time.perf_counter() - t0
    log(f"phase 10 laws and faults: {dt:.2f} s (aim {PHASE10_AIM_S:.0f} s)")
    report["phases"]["laws_faults"] = {"s": dt, **p10}

    # -- phase 11: dynamic graphs ------------------------------------------
    t0 = time.perf_counter()
    p11 = phase_dynamic_graphs(dev, smi)
    dt = time.perf_counter() - t0
    log(f"phase 11 dynamic graphs: {dt:.2f} s (aim {PHASE11_AIM_S:.0f} s)")
    report["phases"]["dynamic_graphs"] = {"s": dt, **p11}

    def entry(name, source, replaces, launches, err):
        tm = p4["timing"][name]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound"][0], "bound_by": tm["bound"][1],
            "library_ms": None,
        }

    kernels = [{
        "name": "walk_transition_ragged",
        "route": "cuda",
        "source": "src/repro_torch/csrc/walk_transition_ragged.cu",
        "replaces": "src/repro/kernels/walk_transition/kernel.py:412",
        "launches": train_launches,
        "max_abs_err": max([c["max_abs_err"] for c in phase1]
                           + [replay["max_abs_err"]]),
        "ms": kernel_ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }, entry(
        "walk_transition_sparse",
        "src/repro_torch/csrc/walk_transition_sparse.cu",
        "src/repro/kernels/walk_transition/kernel.py:215",
        p5["sparse"]["launches"][0],
        max(p4["max_abs_err"]["walk_transition_sparse"],
            p5["sparse"]["replay_max_abs_err"],
            p5["bucketed_compact"]["replay_max_abs_err"]),
    ), entry(
        "walk_transition",
        "src/repro_torch/csrc/walk_transition_dense.cu",
        "src/repro/kernels/walk_transition/kernel.py:139",
        p5["dense"]["launches"][1],
        max(p4["max_abs_err"]["walk_transition"],
            p5["dense"]["replay_max_abs_err"]),
    )]

    def llm_entry(name, source, replaces, launches, tm, err):
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches, "max_abs_err": err,
            "ms": tm["ms"], "plain_ms": tm["plain_ms"],
            "bound_ms": tm["bound_ms"], "bound_by": tm["bound_by"],
            "library_ms": tm["library_ms"],
        }

    mini, mamba = p6["minitron-8b"], p6["mamba2-370m"]
    flash = llm_entry(
        "flash_attention", "src/repro_torch/csrc/flash_attention_wgmma.cu",
        "src/repro/kernels/flash_attention/kernel.py:93",
        mini["prefill"]["routes"]["wgmma_bf16"], mini["kernel"],
        mini["kernel"]["max_abs_err"],
    )
    # float32 inputs take the CUDA-core kernel (the float32 prefill gate)
    flash["routes"] = {
        "wgmma_bf16": {"source": flash["source"],
                       "launches": mini["prefill"]["routes"]["wgmma_bf16"],
                       **mini["kernel"]["routes"]["wgmma_bf16"]},
        "cuda_core_f32": {"source": "src/repro_torch/csrc/flash_attention.cu",
                          "launches": mini["prefill"]["f32_routes"]["cuda_core_f32"],
                          **mini["kernel"]["routes"]["cuda_core_f32"]},
    }
    ssd = llm_entry(
        "ssd_scan", "src/repro_torch/csrc/ssd_scan_mma.cu",
        "src/repro/kernels/ssd/kernel.py:74",
        mamba["prefill"]["ssd_routes"]["mma_bf16"], mamba["kernel"],
        mamba["kernel"]["max_abs_err"],
    )
    # float32 inputs take the CUDA-core kernel (the float32 prefill gate)
    ssd["routes"] = {
        "mma_bf16": {"source": ssd["source"],
                     "launches": mamba["prefill"]["ssd_routes"]["mma_bf16"],
                     **mamba["kernel"]["routes"]["mma_bf16"]},
        "cuda_core_f32": {"source": "src/repro_torch/csrc/ssd_scan.cu",
                          "launches": mamba["prefill"]["f32_ssd_routes"]["cuda_core_f32"],
                          **mamba["kernel"]["routes"]["cuda_core_f32"]},
    }
    kernels += [flash, ssd, llm_entry(
        "rmsnorm_fused", "src/repro_torch/csrc/rmsnorm.cu",
        "src/repro/kernels/rmsnorm/kernel.py:25",
        mini["prefill"]["rmsnorm_launches"] + mamba["prefill"]["rmsnorm_launches"],
        p6["rmsnorm"],
        max(p6["rmsnorm"]["max_abs_err"], mini["prefill"]["rmsnorm_max_abs_err"],
            mamba["prefill"]["rmsnorm_max_abs_err"]),
    )]
    if kernels[-1]["launches"] != 2:
        raise AssertionError("ops.rmsnorm did not launch its kernel once per model")
    # phase 9 launches the sparse kernel once per training step of a figure
    sparse = next(k for k in kernels if k["name"] == "walk_transition_sparse")
    sparse["launches_by_figure"] = {
        name: f["launches"] for name, f in p9["figures"].items()}
    # phase 10's paths, each counted from 0 just before it and read just after
    p10_paths = {"law_sweep": [p10["law_sweep"]["launches"]],
                 "law_trainers": [t["launches"]
                                  for t in p10["trainers"].values()],
                 "faulted_trainers": [f["launches"]
                                      for f in p10["faults"].values()],
                 "fault_sweep": [p10["fault_sweep"]["launches"]],
                 "fig6_seeds": [{"walk_transition_sparse": f["launches"]}
                                for f in p10["fig6_seeds"].values()]}
    for k in kernels:
        by_path = {path: sum(c.get(k["name"], 0) for c in counts)
                   for path, counts in p10_paths.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        if by_path:
            k["launches_phase10"] = by_path
            k["launches"] += sum(by_path.values())
    for name in ("walk_transition_sparse", "walk_transition_ragged"):
        if not next(k for k in kernels if k["name"] == name).get(
                "launches_phase10"):
            raise AssertionError(f"phase 10 launched {name} no time")
    # phase 11's paths, each counted from 0 just before it and read just after
    p11_paths = {"churned_engine": [p11["walks"]["launches_run"]],
                 "churned_layouts": list(p11["walks"]["layouts"].values()),
                 "trainer_across_churn": p11["trainer"]["launches"],
                 "run_dada": [p11["dada"]["launches"]]}
    for k in kernels:
        by_path = {path: sum(c.get(k["name"], 0) for c in counts)
                   for path, counts in p11_paths.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        if by_path:
            k["launches_phase11"] = by_path
            k["launches"] += sum(by_path.values())
    for name in ("walk_transition_sparse", "walk_transition",
                 "walk_transition_ragged"):
        if not next(k for k in kernels if k["name"] == name).get(
                "launches_phase11"):
            raise AssertionError(f"phase 11 launched {name} no time")
    report["kernels"] = kernels
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log("kernels: " + ", ".join(f"{k['name']} launches={k['launches']}"
                                for k in kernels))
    log(f"chip_smoke total: {time.perf_counter() - T_START:.2f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
