"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, started together; ptxas' registers, spills and
warnings are printed, and ``cuobjdump -sass`` must find HGMMA in the bf16
flash-attention library, HMMA in bf16, float16 and TF32 in the
``mma_sync`` flash-attention library (which, like the walk kernels and
the ``mma_tf32`` SSD library, must not spill), HMMA or HGMMA in the bf16
SSD library and TF32 HMMA in the ``mma_tf32`` SSD library), then:

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
   S=4000 and at h=64, its float32 route (``mma_sync``, split TF32) on a
   small shape and at minitron's shape upcast, and both routes timed at
   minitron's shape (TFLOP/s, share of the bound, float32's at a third of
   the TF32 rate); ``ssd_scan``'s bf16 route (``mma_bf16``) on mamba2's layer-0
   inputs (B=4, L=4096, H=32, P=64, N=128, chunk 256) and at L=4000
   through the padding, its float32 route (``mma_tf32``, split TF32) on
   the same inputs upcast, each route's error against the float64 result,
   both routes timed (share of the bound, float32's at a third of the TF32
   rate, the bytes the bf16 design moves, its
   three launches apart under the profiler; the bound counts B and C at
   their groups), ``ops._head_major``'s copies apart and the scan with
   them — with device times, bounds, the
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
   bf16 run against the float32 einsum run; then 7 in float16 at 1 x 4096
   (the bf16 leaves cast, no second build; minitron's 32 launches on
   ``wgmma_bf16``, mamba2's 48 on ``mma_bf16``): each layer's output and
   the final hidden states of the kernel path against the einsum path
   (relative Frobenius error <= ``PREFILL_F16_REL_ERR``), up to the first
   layer that is not finite, if one is (reported), and the kernel path no
   farther from the float32 einsum run than the einsum path (within 25%);
   then ``rmsnorm_fused``
   against its plain version and ``F.rms_norm`` at (4096, 4096) and
   (16384, 1024) in bf16 and float32, with the kernel that ran and the
   share of the bound; then the widened shapes (``phase_widths``):
   paligemma-3b's attention layer 0 at full width (B=1, S=4096, N=8, K=1,
   h=256, causal, bf16) through the wgmma kernel at HD = 256, bf16 at
   h = 80 and 96 (wgmma, zero-filled to 128) and 100 (``mma_sync``),
   float32 at h = 256, float16 at h = 128 (wgmma) and 100 (``mma_sync``),
   bf16 at h = 320 and float32 at h = 512 (``mma_sync``'s slices of the
   output columns), bf16 at h = 128 from an unaligned base (``mma_sync``);
   ``ssd_scan``'s split-TF32
   route (``mma_tf32``) at (P, N) = (128, 256), (80, 200), (192, 128) and
   (64, 512) in float32, chunk 256, and (32, 24) in bf16 and float16,
   chunk 32, its ``mma_bf16`` route in float16 at (64, 128), chunk 256,
   and bf16 (64, 128) from an unaligned base (``mma_tf32``);
   ``rmsnorm_fused`` in float16 and from an unaligned bf16 base at (4096,
   4096): each against its plain version at ``LLM_TOL`` (the SSD cases on
   float32 arithmetic at N * chunk > 64 * 64 by their float64 error, no
   more than twice the plain version's), one launch on its route, with
   device ms, the bound and the plain version's ms (SDPA's for attention,
   ``F.rms_norm``'s for RMSNorm);
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
   the phase would pass what the script's 14-minute aim leaves it after
   the phases before and the time expected after (at most ~5 minutes;
   each cut is printed); each figure's
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
   equal to the uninterrupted run bit for bit; (d) the fault sweep at
   its full scale, its training leg's criterion beside
   ``results/BENCH_faults.json``'s, the rescue-off ratio above the
   rescue-on one at 5% on both families gated, its serving leg audited
   for phase 12; (e) Fig. 6's
   ``annealed_vs_const`` on one more card stream (reported);
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
   BA(100k,3) edges and an SBM 4x250 from injected uniforms, card == CPU;
12. walk-routed serving (aim ``PHASE12_AIM_S``): (a) the routed entry
   point, ``launch.serve.main`` through its own parser, at mamba2-370m's
   full width in float32 (BA(100k,3) ragged, W=512, MHLJ routing, rate
   2.0, 8 slots, 300 + 100 ticks): exit 0, conservation, shed exactly
   once, one ``walk_transition_ragged`` launch a tick; requests/s,
   generated tokens/s, walk-steps/s, p50/p99 ticks, Herfindahl and each
   tick's route / host / decode milliseconds; (b) the reduced model in
   float32 on the same weights on the card and on the CPU, BA(2000,3),
   W=64 at the fault sweep's full serving settings, fault-free and under
   Markov 5%/2% with the rescue: the card's generator-driven run equals
   the card run fed the same streams injected, and those streams on the
   CPU give the same visits, arrival log, request records and fault
   totals, and the same greedy tokens up to a near-tie (phase 8's rule);
   (c) ``paper.serve_throughput`` at its quick tier (six laws, BA(20k,3),
   W=128, 400 + 150 ticks): every law completes, conserves and sheds
   once, every derived key is there; (d) the fault sweep's serving leg,
   run inside phase 10 (d): every replayed leg offered the recorded
   trace, conservation, no rescue with it off;
13. walk-orchestrated LLM training (aim ``PHASE13_AIM_S``), float32, the
   plain layers (the kernels have no backward; under grad they raise): (a)
   ``launch.train.main`` through its own parser on mamba2-370m at full
   width and depth, WS(16,4,0.1), MHLJ with the online estimator, 40 steps
   of 4 x 128: exit 0, finite losses that drop, Remark 1, a spread of L_v,
   one ``walk_transition_sparse`` launch a step; ms/step split by CUDA
   events into host / forward+backward / optimizer / fingerprint / advance,
   steps/s, tokens/s, peak memory; (b) minitron-8b at full width with its
   depth cut to 2 layers: every gradient leaf nonzero, 10 train steps, and
   ``use_kernels=True`` raising the guard without training; (c) the fleet
   step on mamba2-370m at full width cut to 8 layers, W=4, averaging
   every 5, 20 steps:
   the models equal bit for bit exactly after each average; (d) reduced
   qwen2.5-32b and mamba2-370m, 20 steps of ``run_training`` on the card
   and, on the card's blocks, on the CPU: ``uniform`` nodes and hops bit
   for bit, ``mhlj`` nodes up to a near-tie (printed), losses at 1e-3;
   (e) a kill after a step-20 checkpoint and a resume, bit for bit under
   ``torch.use_deterministic_algorithms(True)``, ms/step with and without.
14. the MoE, hybrid and audio families (aim ``PHASE14_AIM_S``), random
   weights from seed 0 in bf16, each model freed before the next: (a)
   jamba-1.5-large-398b at full width cut to one period (8 layers: 7
   mamba, 1 attention, 4 MoE, 4 SwiGLU) and 8 of its 16 experts (4 if 8
   run out of memory; top-2 kept): ``ssd_scan`` on layer 0's inputs (B=1,
   L=4096, H=256, P=64, N=128, G=8, chunk 256; ``mma_bf16``) against its
   plain version, both routes against float64, device time, bound share
   (B and C counted at their 8 groups), ``ops._head_major``'s 32-fold
   group repeat timed, and the scan with it; prefill
   B=1x4096 on both paths (7 ``mma_bf16`` launches, no flash launch;
   tokens/s, peak memory, relative Frobenius error, the MoE dropped
   fraction and expert load); ``ServeEngine`` on the 8 requests; (b)
   deepseek-moe-16b at full width and depth: prefill B=1x4096 (no kernel,
   both paths the same bits) and serving; (c) whisper-tiny at full size:
   ``apply`` on B=4 x (1500 frames, 448 tokens), ``init_cache`` with
   frames equal to ``precompute_cross_kv`` of the encoder's output,
   serving; (d) reduced olmoe, deepseek-moe-16b, jamba (also on its kernel
   path) and whisper in float32, card against CPU on the same weights:
   ``apply``, ``loss`` with ``moe_aux``, 20 decode steps at 2e-4, greedy
   tokens up to a near-tie and the decode up to a token routed otherwise
   at a near-tie of the router, every router call before it within 2e-4;
   routing near-ties counted and printed apart (they excuse nothing); (e)
   ``launch.train.main`` on olmoe-1b-7b at full width cut to 4 layers, 10
   steps of 2 x 128 in float32 (ms/step by phase, peak memory, ``moe_aux``
   in every step's metrics, one sparse launch a step); reduced jamba and
   deepseek-moe-16b 20 steps card against CPU (nodes equal, losses at
   1e-3); the reduced olmoe fleet step (W=4, averaging every 2); reduced
   olmoe killed after a step-10 checkpoint and resumed bit for bit under
   deterministic algorithms.
15. the walker fleet across ranks (aim ``PHASE15_AIM_S``): this process
   joins a one-rank NCCL group (``tcp://localhost``, a free port) and
   builds ``make_walker_mesh()``; (a) phase 3's trainer through
   ``run_rw_sgd_multi(mesh=)`` (captured, the all-reduces in the CUDA
   graphs) against its loop with ``mesh=None`` from the same generator
   state: every field bit for bit, phase 3's walks' digest, 500 ragged
   launches each, both loops' replayed ms/step, the NCCL kernels of a
   profiled window and one eager all-reduce's time; (b) the fleet section
   of the reference's ``benchmarks/large_graph_walk.py`` at ``full``: the
   ragged engine on BA(100k,3) at W = 2048 and 8192 for 200 steps
   (aggregate walk-steps/s, ``sharded``, walks equal to the unsharded
   engine's), then ring(128) at T = 20,000, W = 1, 2, 4, 8, averaging
   every 50 (excess over the floor, hops/update); (c) two NCCL ranks on
   the card, once (NCCL's answer printed), then P = 2 and 4 spawned
   processes on the card over gloo: (a)'s loop for 200 steps plain and
   under Markov faults, and 2049 walkers (replicated), against the same
   runs unsharded in this process (walks and fault state bit for bit,
   floats at the reference's all-reduce tolerances), each rank's ragged
   launches, a gloo all-reduce's time; (d) ``paper.multi_walk`` at T =
   10,000 through (a)'s mesh, gated ``excess_w8 < excess_w1``; (e) in the P = 2
   group, the LLM fleet step of reduced olmoe and mamba2 (W = 4, averaging
   every 2) against the unsharded step on the card.
16. the dry-run and roofline tooling (aim ``PHASE16_AIM_S``): (a)
   minitron-8b and mamba2-370m at full width, bf16, ``use_kernels=True``,
   prefill at 1 x 4096: ``launch.dryrun.lower_case`` plans each on a
   (1, 1) fake mesh (in the CPU process of (b)), then the same prefill
   runs on the card; gated: the plan's argument bytes equal the measured
   bytes of the parameters and
   batch, the FLOPs and bytes ``utils.op_cost`` counts on the kernel path
   equal the plain path's (the priced regions), the card's peak over its
   baseline within ``P16_PEAK_BOUNDS`` of the plan's argument + temp
   bytes; printed: the measured prefill time against the counted
   roofline bound; (b) the plan of minitron-8b and mamba2-370m x the four
   input shapes on the 16x16 mesh, all [OK] with the three roofline terms,
   and the reduced model of each of the six families x train, prefill and
   decode on a fake (2, 2) mesh, all 18 [OK]
   (a CPU process, ``python3 chip_smoke.py --phase16-plans``, started
   before phase 1 at one thread and the lowest priority, its output under
   ``build/phase16-*``); (c) the five ``examples/torch`` scripts on
   the card at the sizes of ``P16_EXAMPLES``, each one's headline line
   printed; its launches counted from 0 just before (a)'s kernel path and
   (c), and read just after.

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
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.launch.mesh import HW  # noqa: E402  (after the path)
from repro_torch.utils.kernel_bounds import (  # noqa: E402
    bound, bound_dense, bound_for_step, bound_sparse, chain_loads,
    flash_bound, rmsnorm_bound, ssd_bound, ssd_mma_bytes,
)

# H100 SXM published peaks (NVIDIA data sheet, repro_torch.launch.mesh.HW):
# HBM bandwidth, the float32 rate outside the tensor cores and the dense
# bf16 tensor-core rate (attention's bound takes its own rate by dtype,
# ``kernel_bounds.flash_ops_per_s``: float32 at a third of TF32's; imported
# where it is used, so that this script still imports beside an older
# checkout's package, as tools/flash_mma_sync.py --src does).
HBM_BYTES_PER_S = HW.HBM_BW
FP32_OPS_PER_S = HW.PEAK_FLOPS_FP32
BF16_OPS_PER_S = HW.PEAK_FLOPS_BF16
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
    """The device activities (kernels, copies, fills) one ``fn(0)`` makes:
    the largest of a ``torch.profiler`` trace's device activities, its
    host CUDA runtime enqueue calls, and the ATen operations other than
    views and ``empty`` that a dispatch mode sees (never fewer than 1).
    CUPTI may record nothing in a trace, so the ATen count, which needs
    no CUPTI, keeps a call of thousands of PyTorch operations from being
    taken for one launch; it misses the port's ctypes launches, which
    the trace counts when it records them and which are a few a call."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class AtenCount(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            if not (func.is_view or func.__name__.startswith("empty")):
                self.n += 1
            return func(*args, **(kwargs or {}))

    with AtenCount() as aten:
        fn(0)
    torch.cuda.synchronize()
    prof = profile_window(lambda: fn(0), "")
    return max(1, aten.n, prof["runtime_launches"],
               sum(prof["device_launches_by_name"].values()))


def timing_site() -> str:
    """Where a timing was asked for: the nearest calling ``phase*``
    function (or ``main``) and the function that called the timer, each
    with its line."""
    caller = sys._getframe(2)
    f = caller
    while f is not None and not (f.f_code.co_name.startswith("phase")
                                 or f.f_code.co_name == "main"):
        f = f.f_back
    site = f"{caller.f_code.co_name}:{caller.f_lineno}"
    return site if f is None or f is caller else (
        f"{f.f_code.co_name}:{f.f_lineno}, {site}")


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
    The untimed warm-up call runs under ``torch.cuda.set_sync_debug_mode(
    "error")``, so a call that synchronizes fails there, under its own
    name, before any hold.  Raises if a hold timed out (a timed call
    waited on the device, or the host took more than the hold's
    ``HOLD_TIMEOUT_NS`` to enqueue a chunk), naming the phase and caller
    (:func:`timing_site`) and the longest chunk's host enqueue seconds.
    Returns ``(device ms per call, host enqueue ms per call, calls per
    held chunk (0: not held))``.
    """
    torch.cuda.set_sync_debug_mode("error")
    try:
        fn(0)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    torch.cuda.synchronize()
    per_call_launches = launches_per_call(fn)
    chunk = HOLD_BUDGET // (per_call_launches + 2)
    flag = torch.zeros(1, dtype=torch.int32, pin_memory=True)
    timed_out = torch.zeros(1, dtype=torch.int32, device="cuda")
    enqueue_s, longest_s, device_ms = 0.0, 0.0, 0.0
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
        took = time.perf_counter() - t
        enqueue_s += took
        longest_s = max(longest_s, took)
        flag.fill_(1)
        torch.cuda.synchronize()
        device_ms += start.elapsed_time(end)
    if int(timed_out.item()):
        raise AssertionError(
            f"device_time_ms at {timing_site()}: a stream hold timed out "
            f"after {HOLD_TIMEOUT_NS / 1e9:.1f} s; the longest chunk took "
            f"{longest_s:.3f} s of host enqueue ({chunk} calls a chunk, "
            f"{per_call_launches} launches a call): a timed call waited on "
            "the device, or the host stalled past the hold")
    if not chunk:
        log(f"    (not held: {per_call_launches} launches a call exceed the "
            f"hold's {HOLD_BUDGET}; host gaps are in this time)")
    return device_ms / iters, enqueue_s * 1e3 / iters, chunk


# the CUDA runtime and driver calls that each put one activity on a stream
RUNTIME_ENQUEUES = frozenset((
    "cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
    "cuLaunchKernelEx", "cudaMemcpyAsync", "cudaMemsetAsync",
    "cudaLaunchCooperativeKernel"))


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
    runtime_launches = sum(
        1 for e in events
        if e.device_type == torch.autograd.DeviceType.CPU
        and e.time_range.start >= start and e.name in RUNTIME_ENQUEUES)
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
                "device_launches_by_name": {},
                "runtime_launches": runtime_launches}
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
            "device_launches_by_name": count_by_name,
            "runtime_launches": runtime_launches}


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

# tests/test_kernels.py's tolerances (atol = rtol), float32 / bfloat16, and
# float16's as tests/test_torch_kernel_dtypes.py sets them from measurement
LLM_TOL = {"flash_attention": {torch.float32: 2e-5, torch.bfloat16: 2e-2,
                               torch.float16: 2e-3},
           "ssd_scan": {torch.float32: 2e-4, torch.bfloat16: 6e-2,
                        torch.float16: 2e-3},
           "rmsnorm_fused": {torch.float32: 1e-5, torch.bfloat16: 3e-2,
                             torch.float16: 2e-3}}
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


def phase_flash(model, cfg, dev, gen) -> dict:
    """``flash_attention`` against its plain version: the bf16 route
    (``wgmma_bf16``) on minitron-8b's layer 0 q/k/v (B=1, S=4096, N=32,
    K=8, h=128, causal), at S=4000 (the tail mask) and at h=64; the float32
    route (``mma_sync``) on a small shape and on minitron's q/k/v upcast.
    Device times of both routes at minitron's shape (float32: the same
    q/k/v upcast), achieved TFLOP/s and share of the bound (float32 at the
    split-TF32 rate), the plain version's time and SDPA's (a yardstick
    only: the port never calls it)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.models.layers import attention as attn_mod
    from repro_torch.models.layers.norms import rmsnorm
    from repro_torch.utils.kernel_bounds import flash_ops_per_s

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
    errs["mma_sync"] = [hold("flash_attention", fa_ops.mha(qf, kf, vf, causal=True),
                             mha_ref(qf, kf, vf, causal=True), f32,
                             "at B=1 S=1000 N=8 K=2 float32")]
    qf, kf, vf = (t.float() for t in (q, k, v))
    errs["mma_sync"].append(hold(
        "flash_attention", fa_ops.mha(qf, kf, vf, causal=True),
        mha_ref(qf, kf, vf, causal=True), f32, "at minitron's layer in float32"))
    del qf, kf, vf
    went = {r: fa_ops.mha.launches_by_route[r] - before[r] for r in before}
    if went != {"wgmma_bf16": 3, "mma_sync": 2}:
        raise AssertionError(f"flash_attention took the routes {went}")
    nbytes, ops = flash_bound(1, s, s, cfg.num_heads, cfg.num_kv_heads, 128, 2,
                              True, 0)
    routes = {}
    for route, dtype in (("wgmma_bf16", bf16), ("mma_sync", f32)):
        peak = flash_ops_per_s(dtype.itemsize)
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        ms = device_time_ms(lambda i: fa_ops.mha(qd, kd, vd, causal=True),
                            20 if dtype == bf16 else 10)
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


def ssd_inputs(model, lp, tokens) -> tuple:
    """The SSD scan's inputs ``(xs, dt, a, bs, cs)`` in the model layout for
    mamba layer ``lp`` (a ``{"ln", "mixer"}`` group) on ``tokens``' embeddings,
    as ``mamba_apply`` computes them."""
    import torch.nn.functional as F

    from repro_torch.models.layers import mamba2 as mamba_mod
    from repro_torch.models.layers.norms import rmsnorm

    dims = model.mdims
    with torch.no_grad():
        x = rmsnorm(lp["ln"], model.embedding["table"][tokens], model.cfg.norm_eps)
        _, conv_in, dt_raw = mamba_mod._split_proj(lp["mixer"], x, dims)
        conv = F.silu(mamba_mod._causal_conv(conv_in, lp["mixer"]["conv_w"],
                                             lp["mixer"]["conv_b"]))
        xs, bs, cs = mamba_mod._split_conv_out(conv, dims)
        dt = F.softplus(dt_raw.float() + lp["mixer"]["dt_bias"])
        a = -torch.exp(lp["mixer"]["a_log"])
    return xs, dt, a, bs, cs


def phase_ssd(model, cfg, dev, gen) -> dict:
    """``ssd_scan`` on mamba2-370m's layer 0 (B=4, L=4096, H=32, P=64,
    N=128, chunk 256): the bf16 route (``mma_bf16``) against its plain
    version there and at L=4000 through ``ops.ssd``'s padding, and the
    float32 route (``mma_tf32``) on the same inputs upcast; both
    routes, at both lengths, held to the float64 result too (no more than
    twice the plain version's error), each error logged beside the plain
    version's and max |y|.  Device times of both routes with the share of
    the bound (float32's operations at a third of the TF32 rate), the bytes
    the bf16 route's design moves, and ``ops._head_major``'s copies timed
    apart."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.utils.kernel_bounds import ssd_ops_per_s

    b, l = 4, 4096
    tokens = torch.randint(0, cfg.vocab_size, (b, l), generator=gen, device=dev)
    dims = model.mdims
    xs, dt, a, bs, cs = ssd_inputs(model, model.layers[0], tokens)
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
    if went != {"mma_bf16": 2, "mma_tf32": 1}:
        raise AssertionError(f"ssd_scan took the routes {went}")
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    top = float(exact.abs().max())
    err64 = {name: float((t.double() - exact).abs().max())
             for name, t in (("mma_bf16", y), ("mma_tf32", y32),
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
                           ("mma_tf32", "plain")):
        if not err64[route] <= 2 * err64[ref_key]:
            raise AssertionError(f"ssd_scan {route} against float64: {err64}")
    errs["mma_tf32"] = [float((y32 - plain_y).abs().max())]
    log(f"  ssd_scan max abs err against the float64 result (max |y| "
        f"{top:.3e}): mma_bf16 {err64['mma_bf16']:.3e} (L=4000 through ops.ssd "
        f"{err64['mma_bf16_l4000']:.3e}), mma_tf32 (inputs upcast) "
        f"{err64['mma_tf32']:.3e}, plain version {err64['plain']:.3e} "
        f"(rows < 4000: {err64['plain_l4000']:.3e})")
    plain = device_time_ms(lambda i: ssd_scan_ref(*args, chunk=chunk), 3)
    head_major = device_time_ms(lambda i: ssd_ops._head_major(xs, dt, a, bs, cs), 10)
    path = device_time_ms(lambda i: ssd_ops.ssd_scan(
        *ssd_ops._head_major(xs, dt, a, bs, cs), chunk=chunk), 20)
    g = dims.num_groups
    nbytes, ops = ssd_bound(b, h, l, p, n, chunk, 2, g)
    log(f"  ops._head_major (layout change, group repeat of B and C): "
        f"{head_major[0]:.4f} ms on the device; with the mma_bf16 scan "
        f"{path[0]:.4f} ms ({bound(nbytes, ops, BF16_OPS_PER_S)[0] / path[0]:.1%} "
        f"of the bound)")
    design = ssd_mma_bytes(b, h, l, p, n, chunk)
    routes = {}
    for route, t, peak, iters in (("mma_bf16", args, BF16_OPS_PER_S, 20),
                                  ("mma_tf32", args32, ssd_ops_per_s(4), 10)):
        ms = device_time_ms(lambda i: ssd_ops.ssd_scan(*t, chunk=chunk), iters)
        rb = ssd_bound(b, h, l, p, n, chunk, t[0].element_size(), g)[0]
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
            "path_ms": path[0],
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
            nbytes, rms_ops_n = rmsnorm_bound(rows, d, x.element_size())
            b_ms, b_by = bound(nbytes, rms_ops_n, FP32_OPS_PER_S)
            key = f"{rows}x{d}_{str(dtype).split('.')[-1]}"
            out[key] = {"ms": ms[0], "plain_ms": plain[0], "library_ms": lib[0],
                        "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
                        "kernel": kernel, "bound_share": b_ms / ms[0]}
            log(f"  rmsnorm_fused {key} ({'/'.join(kernel)} kernel): {ms[0]:.5f} "
                f"ms/launch on the device ({b_ms / ms[0]:.1%} of its bound "
                f"{b_ms:.5f} ms by {b_by}), plain {plain[0]:.5f} ms, F.rms_norm "
                f"{lib[0]:.5f} ms (kernel / F.rms_norm {ms[0] / lib[0]:.3f})")
    return {"max_abs_err": max(errs), "shapes": out, **out["4096x4096_bfloat16"]}


# phase 6's widened shapes: the inputs the three kernels take beyond the main
# path's (bf16 and float32; h 64 and 128; P 64, N 64 and 128).  Attention:
# (label, dtype, (B, S, T, N, K, h), causal, window, route, aligned);
# paligemma-3b's layer (h=256, MQA) is made from the model's own weights.
# SSD: (label, dtype, (B, H, L, P, N, chunk), route, aligned).  RMSNorm:
# (label, dtype, (rows, D), aligned).  An unaligned case reads its first
# input from 2 bytes past a 16-byte boundary.
P6_FLASH_WIDTHS = (
    ("bf16 h=80", torch.bfloat16, (1, 4096, 4096, 16, 4, 80), True, 0,
     "wgmma_bf16", True),
    ("bf16 h=96", torch.bfloat16, (1, 4096, 4096, 16, 4, 96), True, 0,
     "wgmma_bf16", True),
    ("bf16 h=100", torch.bfloat16, (1, 4096, 4096, 16, 4, 100), True, 0,
     "mma_sync", True),
    ("float32 h=256", torch.float32, (1, 4096, 4096, 8, 1, 256), True, 0,
     "mma_sync", True),
    ("float16 h=128", torch.float16, (1, 4096, 4096, 32, 8, 128), True, 0,
     "wgmma_bf16", True),
    ("float16 h=100", torch.float16, (1, 4096, 4096, 16, 4, 100), True, 0,
     "mma_sync", True),
    ("bf16 h=320", torch.bfloat16, (1, 4096, 4096, 8, 1, 320), True, 0,
     "mma_sync", True),
    ("float32 h=512", torch.float32, (1, 4096, 4096, 8, 1, 512), True, 0,
     "mma_sync", True),
    ("bf16 h=128 unaligned", torch.bfloat16, (1, 4096, 4096, 32, 8, 128),
     True, 0, "mma_sync", False),
)
P6_SSD_WIDTHS = (
    ("float32 P=128 N=256", torch.float32, (1, 16, 4096, 128, 256, 256),
     "mma_tf32", True),
    ("float32 P=80 N=200", torch.float32, (1, 16, 4096, 80, 200, 256),
     "mma_tf32", True),
    ("bf16 P=32 N=24", torch.bfloat16, (1, 16, 4096, 32, 24, 32),
     "mma_tf32", True),
    ("float16 P=64 N=128", torch.float16, (1, 32, 4096, 64, 128, 256),
     "mma_bf16", True),
    ("float16 P=32 N=24", torch.float16, (1, 16, 4096, 32, 24, 32),
     "mma_tf32", True),
    ("float32 P=192 N=128", torch.float32, (1, 16, 4096, 192, 128, 256),
     "mma_tf32", True),
    ("float32 P=64 N=512", torch.float32, (1, 16, 4096, 64, 512, 256),
     "mma_tf32", True),
    ("bf16 P=64 N=128 unaligned", torch.bfloat16, (1, 32, 4096, 64, 128, 256),
     "mma_tf32", False),
)
# phase 6's float16 range cases on mma_bf16, tests/test_torch_cuda.py's
# SSD_RANGE_CASES "probe" and "strong" (drawn here from the script's
# generator): the float32 operands the kernel splits pass float16's 65504.
# (label, (B, H, L, P, N, chunk), scale of |x| and |B|, da); dt = 1, C =
# 0.01 N(0, 1).
P6_SSD_RANGES = (
    ("float16 range probe P=64 N=64", (1, 2, 512, 64, 64, 64), 16.0, -1e-3),
    ("float16 range strong P=64 N=128", (1, 2, 1024, 64, 128, 256), 64.0,
     -1e-4),
)
FLOAT16_MAX = 65504.0
P6_RMSNORM_WIDTHS = (
    ("float16 (4096, 4096)", torch.float16, (4096, 4096), True),
    ("bf16 (4096, 4096) unaligned", torch.bfloat16, (4096, 4096), False),
)


def randn_at(shape, dtype, gen, dev, aligned: bool = True) -> torch.Tensor:
    """N(0, 1) of ``shape`` in ``dtype``; with ``aligned=False`` a view whose
    base is 2 bytes past a 16-byte boundary (what TMA and cp.async cannot
    read)."""
    n = math.prod(shape)
    buf = torch.randn(n + (0 if aligned else 1), generator=gen,
                      device=dev).to(dtype)
    x = (buf if aligned else buf[1:]).view(shape)
    if aligned != (x.data_ptr() % 16 == 0):
        raise AssertionError(f"base {x.data_ptr()} is not what was asked")
    return x


def ssd_f64_rule(dtype, route: str, n: int, chunk: int) -> bool:
    """Whether an SSD case is held to the float64 result (its error no more
    than twice the plain version's) rather than at ``LLM_TOL``: float32
    arithmetic (float32 inputs, or 16 bits on the split-TF32 route, whose
    float32 operands split as float32's do) at N * chunk > 64 * 64, where
    two float32 summation orders of ~1e5 products differ by more than the
    tolerance (tests/test_torch_cuda.py's rule, ``_hold_ssd``)."""
    return n * chunk > 64 * 64 and (dtype == torch.float32
                                    or route == "mma_tf32")


# a float16 range case past N * chunk = 64 * 64 (outputs to ~1e6) is held to
# the float64 result within this share of its largest output, the float16
# mma route's rule in tests/test_torch_cuda.py: no float32 summation order
# is within LLM_TOL there where outputs cancel, and the kernel's float32
# sums in the tensor cores miss the float64 result by up to 6x the plain
# version's error (its bf16 build by up to 9x; tools/ssd_float16_range.py)
SSD_RANGE_TOP_SHARE = 1e-4


def ssd_split_peaks(xs, da, dt, bs, cs, chunk: int) -> dict:
    """The largest |B (.) w|, |enter| (the state entering a chunk) and
    |att| over all chunks: the float32 operands ``csrc/ssd_scan_mma.cu``
    splits into 16-bit hi + lo, by the plain float32 chunked scan
    (``ssd_scan_ref``'s arithmetic) on the inputs' device."""
    b, h, l, p = xs.shape
    n = bs.shape[-1]
    dev = xs.device
    state = torch.zeros((b, h, n, p), dtype=torch.float32, device=dev)
    causal = torch.ones((chunk, chunk), dtype=torch.bool, device=dev).tril()
    peak = {k: torch.zeros((), device=dev) for k in ("b_w", "enter", "att")}
    for c0 in range(0, l, chunk):
        x, dtc, bb, cc = (t[:, :, c0:c0 + chunk].float() for t in (xs, dt, bs, cs))
        cum = torch.cumsum(da[:, :, c0:c0 + chunk].float(), dim=-1)
        att = torch.where(causal, (cc @ bb.transpose(-1, -2)) * torch.exp(
            cum[..., :, None] - cum[..., None, :]), 0.0) * dtc[..., None, :]
        bw = bb * (torch.exp(cum[..., -1:] - cum) * dtc)[..., None]
        for k, v in (("b_w", bw), ("enter", state), ("att", att)):
            peak[k] = torch.maximum(peak[k], v.abs().max())
        state = (torch.exp(cum[..., -1])[..., None, None] * state
                 + bw.transpose(-1, -2) @ x)
    return {k: float(v) for k, v in peak.items()}


def paligemma_layer_qkv(dev, gen) -> tuple:
    """q, k, v of paligemma-3b's attention layer 0 at full width (B=1,
    S=4096, N=8, K=1, h=256, bf16), from its seed-0 weights (the model cut
    to that one layer) on random tokens."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.models.factory import build_model
    from repro_torch.models.layers import attention as attn_mod
    from repro_torch.models.layers.norms import rmsnorm

    cfg = dataclasses.replace(get_arch("paligemma-3b"), num_layers=1)
    gen.manual_seed(0)
    model = build_model(cfg, torch.bfloat16, device=dev, generator=gen)
    s = 4096
    tokens = torch.randint(0, cfg.vocab_size, (1, s), generator=gen, device=dev)
    lp = model.layers[0]
    with torch.no_grad():
        x = rmsnorm(lp["ln1"], model.embedding["table"][tokens], cfg.norm_eps)
        q, k, v = attn_mod._project_qkv(
            lp["attn"], x, model.dims, torch.arange(s, device=dev).expand(1, s))
    out = tuple(t.contiguous() for t in (q, k, v))
    del model, x
    torch.cuda.empty_cache()
    return out


def phase_widths(dev, gen) -> dict:
    """Phase 6's widened inputs: each of ``P6_FLASH_WIDTHS`` (after
    paligemma-3b's layer through the wgmma kernel at HD = 256), of
    ``P6_SSD_WIDTHS`` and of ``P6_RMSNORM_WIDTHS`` against its plain
    version at ``LLM_TOL`` (the SSD cases ``ssd_f64_rule`` names against
    the float64 result, no worse than twice the plain version), one launch
    on its route (or RMSNorm kernel); device ms by held CUDA events, the
    bound from ``utils/kernel_bounds.py``, the plain version's ms and, for
    attention and RMSNorm, SDPA's and ``F.rms_norm``'s on the same call (a
    yardstick only: the port never calls them)."""
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.flash_attention.ref import mha_ref
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rmsnorm.ref import rmsnorm_ref
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.utils.kernel_bounds import flash_ops_per_s, ssd_ops_per_s

    out = {"flash_attention": {}, "ssd_scan": {}, "rmsnorm_fused": {}}
    flash_cases = [("paligemma-3b layer 0 bf16 h=256", torch.bfloat16,
                    paligemma_layer_qkv(dev, gen), True, 0, "wgmma_bf16")]
    for (label, dtype, (b, s, t, n, kh, h), causal, window, route,
         aligned) in P6_FLASH_WIDTHS:
        qkv = (randn_at((b, s, n, h), dtype, gen, dev, aligned),
               *(randn_at((b, t, kh, h), dtype, gen, dev) for _ in range(2)))
        flash_cases.append((label, dtype, qkv, causal, window, route))
    for label, dtype, (q, k, v), causal, window, route in flash_cases:
        b, s, n, h = q.shape
        t, kh = k.shape[1], k.shape[2]
        aligned = all(x.data_ptr() % 16 == 0 for x in (q, k, v))
        if fa_ops.route_of(dtype, h, aligned) != route:
            raise AssertionError(f"flash_attention {label}: route "
                                 f"{fa_ops.route_of(dtype, h, aligned)}, not {route}")
        before = dict(fa_ops.mha.launches_by_route)
        got = fa_ops.mha(q, k, v, causal=causal, window=window)
        went = {r: fa_ops.mha.launches_by_route[r] - before[r] for r in before}
        if went != {r: int(r == route) for r in before}:
            raise AssertionError(f"flash_attention {label} took the routes {went}")
        err = hold("flash_attention", got, mha_ref(q, k, v, causal=causal,
                                                   window=window), dtype,
                   f"at {label} (B={b} S={s} N={n} K={kh}, {route})")
        del got
        ms = device_time_ms(lambda i: fa_ops.mha(q, k, v, causal=causal,
                                                 window=window), 10)
        plain = device_time_ms(lambda i: mha_ref(q, k, v, causal=causal,
                                                 window=window), 3)
        qt, kt, vt = (x.transpose(1, 2) for x in (q, k, v))
        lib = device_time_ms(
            lambda i: torch.nn.functional.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, enable_gqa=True), 10)
        nbytes, ops = flash_bound(b, s, t, n, kh, h, q.element_size(), causal,
                                  window if causal else 0)
        b_ms, b_by = bound(nbytes, ops, flash_ops_per_s(q.element_size()))
        out["flash_attention"][label] = {
            "route": route, "dtype": str(dtype).split(".")[-1],
            "aligned": aligned, "shape": [b, s, t, n, kh, h], "launches": 1,
            "max_abs_err": err, "ms": ms[0], "plain_ms": plain[0],
            "library_ms": lib[0], "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms[0]}
        log(f"  flash_attention {label} ({route}): {ms[0]:.4f} ms/launch on "
            f"the device ({b_ms / ms[0]:.1%} of its bound {b_ms:.5f} ms by "
            f"{b_by}), plain {plain[0]:.4f} ms, SDPA {lib[0]:.4f} ms "
            f"({ms[0] / lib[0]:.2f}x SDPA)")
    del flash_cases, q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    ssd_cases = [(*case, None) for case in P6_SSD_WIDTHS] + [
        (label, torch.float16, shape, "mma_bf16", True, (scale, rate))
        for label, shape, scale, rate in P6_SSD_RANGES]
    for (label, dtype, (b, h, l, p, n, chunk), route, aligned,
         spread) in ssd_cases:
        if spread is None:
            xs = randn_at((b, h, l, p), dtype, gen, dev, aligned)
            dt = torch.nn.functional.softplus(
                torch.randn((b, h, l), generator=gen, device=dev))
            da = dt * -torch.exp(0.3 * torch.randn(h, generator=gen, device=dev))[:, None]
            bs, cs = (randn_at((b, h, l, n), dtype, gen, dev) for _ in range(2))
        else:
            scale, rate = spread
            xs, bs = ((scale * torch.randn(shape, generator=gen, device=dev).abs())
                      .to(dtype) for shape in ((b, h, l, p), (b, h, l, n)))
            cs = (0.01 * torch.randn((b, h, l, n), generator=gen, device=dev)).to(dtype)
            dt = torch.ones((b, h, l), device=dev)
            da = torch.full((b, h, l), rate, device=dev)
        args = (xs, da, dt, bs, cs)
        peaks = ssd_split_peaks(*args, chunk) if spread else None
        if peaks:
            log(f"  ssd_scan {label}: the split operands' largest magnitudes "
                f"before scaling, |B (.) w| {peaks['b_w']:.4e}, |enter| "
                f"{peaks['enter']:.4e}, |att| {peaks['att']:.4e} (float16's "
                f"largest {FLOAT16_MAX:.0f})")
            if not max(peaks.values()) > FLOAT16_MAX:
                raise AssertionError(f"ssd_scan {label}: no operand past "
                                     f"float16's range: {peaks}")
        if ssd_ops.route_of(dtype, p, n, chunk, aligned) != route:
            raise AssertionError(f"ssd_scan {label}: not the {route} route")
        before = dict(ssd_ops.ssd_scan.launches_by_route)
        y = ssd_ops.ssd_scan(*args, chunk=chunk)
        went = {r: ssd_ops.ssd_scan.launches_by_route[r] - before[r]
                for r in before}
        if went != {r: int(r == route) for r in before}:
            raise AssertionError(f"ssd_scan {label} took the routes {went}")
        plain_y = ssd_scan_ref(*args, chunk=chunk)
        exact = ssd_scan_ref(*(x.double() for x in args), chunk=chunk)
        err64 = {"kernel": float((y.double() - exact).abs().max()),
                 "plain": float((plain_y.double() - exact).abs().max())}
        top = float(exact.abs().max())
        log(f"  ssd_scan {label} against the float64 result (max |y| "
            f"{top:.3e}): kernel {err64['kernel']:.3e}, plain version "
            f"{err64['plain']:.3e}")
        del exact
        where = f"at {label} (B={b} H={h} L={l} chunk {chunk}, {route})"
        if spread is not None and n * chunk > 64 * 64:
            err = float((y - plain_y).abs().max())
            if not (torch.isfinite(y).all()
                    and err64["kernel"] <= SSD_RANGE_TOP_SHARE * top):
                raise AssertionError(f"ssd_scan {where} against float64: "
                                     f"{err64}, max |y| {top}")
            log(f"  ssd_scan vs plain {where}: max abs err {err:.3e}; against "
                f"float64 {err64['kernel'] / top:.3e} of max |y| (rule: <= "
                f"{SSD_RANGE_TOP_SHARE}), {err64['kernel'] / err64['plain']:.2f}x "
                f"the plain version's error")
        elif ssd_f64_rule(dtype, route, n, chunk):
            # two float32 summation orders of ~1e5 products (|y| ~ 450
            # here) differ by more than the tolerance: held to the float64
            # result, no worse than twice the plain version's error, as
            # tests/test_torch_cuda.py holds the route at N * chunk > 64 * 64
            err = float((y - plain_y).abs().max())
            if not err64["kernel"] <= 2 * err64["plain"]:
                raise AssertionError(f"ssd_scan {where} against float64: {err64}")
            log(f"  ssd_scan vs plain {where}: max abs err {err:.3e}; against "
                f"float64 {err64['kernel'] / err64['plain']:.2f}x the plain "
                f"version's error (rule: <= 2x)")
        else:
            err = hold("ssd_scan", y, plain_y, dtype, where)
        del y, plain_y
        ms = device_time_ms(lambda i: ssd_ops.ssd_scan(*args, chunk=chunk), 10)
        plain = device_time_ms(lambda i: ssd_scan_ref(*args, chunk=chunk), 3)
        nbytes, ops = ssd_bound(b, h, l, p, n, chunk, xs.element_size(), h)
        b_ms, b_by = bound(nbytes, ops, ssd_ops_per_s(xs.element_size()))
        out["ssd_scan"][label] = {
            "route": route, "dtype": str(dtype).split(".")[-1],
            "aligned": aligned, "shape": [b, h, l, p, n, chunk],
            "launches": 1, "max_abs_err": err, "max_abs_err_vs_f64": err64,
            "ms": ms[0], "plain_ms": plain[0], "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms[0],
            "split_peaks": peaks}
        log(f"  ssd_scan {label} ({route}): {ms[0]:.4f} ms/launch on the "
            f"device ({b_ms / ms[0]:.1%} of its bound {b_ms:.5f} ms by "
            f"{b_by}), plain {plain[0]:.4f} ms")
    del args, xs, da, dt, bs, cs
    torch.cuda.empty_cache()
    for label, dtype, (rows, d), aligned in P6_RMSNORM_WIDTHS:
        x = randn_at((rows, d), dtype, gen, dev, aligned)
        scale = 1.0 + 0.1 * torch.randn(d, generator=gen, device=dev)
        kernel = rms_ops.kernel_for(d, dtype, aligned)
        before = dict(rms_ops.rmsnorm_fused.launches_by_kernel)
        err = hold("rmsnorm_fused", rms_ops.rmsnorm(x, scale),
                   rmsnorm_ref(x, scale), dtype, f"at {label}")
        went = {k: rms_ops.rmsnorm_fused.launches_by_kernel[k] - before[k]
                for k in before}
        if went != {k: int(k == kernel) for k in before}:
            raise AssertionError(f"rmsnorm_fused {label} took the kernels {went}")
        ms = device_time_ms(lambda i: rms_ops.rmsnorm(x, scale), 20)
        plain = device_time_ms(lambda i: rmsnorm_ref(x, scale), 10)
        w = scale.to(dtype)
        lib = device_time_ms(lambda i: torch.nn.functional.rms_norm(
            x, (d,), weight=w, eps=1e-6), 20)
        nbytes, n_ops = rmsnorm_bound(rows, d, x.element_size())
        b_ms, b_by = bound(nbytes, n_ops, FP32_OPS_PER_S)
        out["rmsnorm_fused"][label] = {
            "kernel": kernel, "dtype": str(dtype).split(".")[-1],
            "aligned": aligned, "shape": [rows, d], "launches": 1,
            "max_abs_err": err, "ms": ms[0], "plain_ms": plain[0],
            "library_ms": lib[0], "bound_ms": b_ms, "bound_by": b_by,
            "bound_share": b_ms / ms[0]}
        log(f"  rmsnorm_fused {label} ({kernel} kernel): {ms[0]:.5f} ms/launch "
            f"on the device ({b_ms / ms[0]:.1%} of its bound {b_ms:.5f} ms by "
            f"{b_by}), plain {plain[0]:.5f} ms, F.rms_norm {lib[0]:.5f} ms")
    return out


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Relative Frobenius error of ``a`` against ``b``, in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def mamba_layers(model) -> int:
    """The model's mamba mixers: one ``ssd_scan`` each on the kernel path."""
    if model.cfg.family == "ssm":
        return model.cfg.num_layers
    if model.cfg.family == "hybrid":
        return model.counts["mamba"] * len(model.periods)
    return 0


def both_paths(model, cfg, tokens, *, finite: bool = True,
               layers: dict = None) -> dict:
    """``apply`` with ``use_kernels=True`` (launches counted from 0; one
    kernel per dense attention or mamba layer and nothing else, or raise)
    and with the einsum path on the same weights, each timed with its peak
    memory; raise on a non-finite output unless ``finite=False``.  With a
    dict ``layers``, ``layers[path]`` gets each layer's output (the model
    module's ``scan_layers`` wrapped while the path runs)."""
    import dataclasses

    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.ssd import ops as ssd_ops

    counters = {"flash_attention": fa_ops.mha, "ssd_scan": ssd_ops.ssd_scan,
                "rmsnorm_fused": rms_ops.rmsnorm_fused}
    n_mamba = mamba_layers(model)
    expect = {"flash_attention": cfg.num_layers if cfg.family == "dense" else 0,
              "ssd_scan": n_mamba, "rmsnorm_fused": 0}
    # the flash and SSD routes the model's dtype (and SSD shape) take, once
    # per layer
    dtype = model.embedding["table"].dtype
    route = fa_ops.route_of(dtype)
    expect_routes = {r: expect["flash_attention"] if r == route else 0
                     for r in fa_ops.mha.launches_by_route}
    expect_ssd = dict.fromkeys(ssd_ops.ROUTES, 0)
    if n_mamba:
        d = model.mdims
        expect_ssd[ssd_ops.route_of(dtype, d.head_dim, d.d_state, d.chunk)] = n_mamba
    module = sys.modules[type(model).__module__]
    scan_layers = module.scan_layers if layers is not None else None
    out = {}
    for path, use_kernels in (("kernel", True), ("einsum", False)):
        model.cfg = dataclasses.replace(cfg, use_kernels=use_kernels)
        if layers is not None:
            seen = layers[path] = []

            def recording(body, stack, x, *args, seen=seen, **kw):
                def body_seen(lp, x):
                    x = body(lp, x)
                    seen.append(x)
                    return x
                return scan_layers(body_seen, stack, x, *args, **kw)

            module.scan_layers = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        for c in counters.values():
            c.launches = 0
        fa_ops.mha.launches_by_route = dict.fromkeys(expect_routes, 0)
        ssd_ops.ssd_scan.launches_by_route = dict.fromkeys(expect_ssd, 0)
        t0 = time.perf_counter()
        try:
            h = model.apply({"tokens": tokens})
            torch.cuda.synchronize()
        finally:
            if layers is not None:
                module.scan_layers = scan_layers
        out[path] = {"h": h, "s": time.perf_counter() - t0,
                     "peak_bytes": torch.cuda.max_memory_allocated(),
                     "launches": {k: c.launches for k, c in counters.items()},
                     "routes": dict(fa_ops.mha.launches_by_route),
                     "ssd_routes": dict(ssd_ops.ssd_scan.launches_by_route)}
        if tuple(h.shape) != (*tokens.shape, cfg.d_model) or (
                finite and not torch.isfinite(h).all()):
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
    with torch.no_grad():  # the scale is a trainable parameter
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


def prefill_accuracy(model, cfg, pre: dict) -> tuple:
    """The same weights upcast to float32 (in place; the model is not used
    in bf16 again): the kernel path against the einsum path (relative
    Frobenius error <= 2e-4), and both bf16 runs against the float32
    einsum run (the kernel path no farther from it than the einsum path,
    within 25%).  Returns the numbers, the tokens and the float32 einsum
    run's output (the float16 leg's yardstick)."""
    model.float()
    tokens = pre.pop("tokens")
    runs = both_paths(model, cfg, tokens)
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
            "f32_einsum_s": runs["einsum"]["s"]}, tokens, h_e32


# phase 7's float16 leg: the kernel path against the einsum path on the
# same float16 weights, as a relative Frobenius error of each layer's output
# and of the final hidden states (the reduced models' float16 tolerance,
# tests/test_torch_kernel_dtypes.py); and, as in bf16, the kernel path no
# farther from the float32 einsum run than the einsum path, within 25%
PREFILL_F16_REL_ERR = 1.5e-2


def prefill_float16(model, cfg, tokens, h_e32, names) -> dict:
    """The float16 leg of phase 7: the parameters ``names`` (those the bf16
    model held in bf16; the float32 norm scales and SSM leaves stay float32,
    as ``build_model(cfg, torch.float16)`` makes them) cast to float16 in
    place (no second build), then prefill of ``tokens`` (1 x 4096) on both
    paths with each layer's output recorded:
    launches per route (one a layer on the 16-bit routes), and, up to the
    first layer whose output is not finite on either path (reported; the
    random float16 stack may overflow, as the reference's would), each
    layer's kernel-path output against the einsum path's at
    ``PREFILL_F16_REL_ERR``; with every layer finite, the final hidden
    states too, and their distance to the float32 einsum run against the
    einsum path's (``PREFILL_BF16_RATIO``).  The warm call also takes, from
    each mamba layer's own ``ssd_scan`` inputs, the largest float32 operands
    the ``mma_bf16`` route splits (:func:`ssd_split_peaks`), reported as
    ratios to float16's largest value (a measurement, not gated)."""
    import dataclasses

    from repro_torch.kernels.ssd import ops as ssd_ops

    with torch.no_grad():
        for name, prm in model.named_parameters():
            if name in names:
                prm.data = prm.data.to(torch.float16)
    model.cfg = dataclasses.replace(cfg, use_kernels=True)
    peaks, scan = [], ssd_ops._ssd_scan

    def scan_with_peaks(xs, da, dt, bs, cs, chunk):
        peaks.append(ssd_split_peaks(xs, da, dt, bs, cs, chunk))
        return scan(xs, da, dt, bs, cs, chunk)

    ssd_ops._ssd_scan = scan_with_peaks
    try:
        model.apply({"tokens": tokens})  # warm: the float16 builds' first launches
    finally:
        ssd_ops._ssd_scan = scan
    if len(peaks) != mamba_layers(model):
        raise AssertionError(f"{cfg.name} float16: split peaks of {len(peaks)} "
                             f"layers, not {mamba_layers(model)}")
    margin = {k: max((pk[k] for pk in peaks), default=0.0) / FLOAT16_MAX
              for k in ("b_w", "enter", "att")}
    if peaks:
        top = {k: max(range(len(peaks)), key=lambda i, k=k: peaks[i][k])
               for k in margin}
        log(f"  {cfg.name} float16: the mma_bf16 route's split operands over "
            f"its {len(peaks)} mamba layers, largest / {FLOAT16_MAX:.0f}: "
            + ", ".join(f"|{k}| {margin[k]:.4e} (layer {top[k]})"
                        for k in margin))
    layers = {}
    runs = both_paths(model, cfg, tokens, finite=False, layers=layers)
    k, e = runs["kernel"], runs["einsum"]
    finite = {path: [bool(torch.isfinite(x).all()) for x in layers[path]]
              for path in layers}
    first = min((f.index(False) for f in finite.values() if False in f),
                default=None)
    gated = len(finite["kernel"]) if first is None else first
    rel_layers = [rel_err(a, b) for a, b in
                  zip(layers["kernel"][:gated], layers["einsum"][:gated])]
    del layers
    out = {"launches": k["launches"], "routes": k["routes"],
           "ssd_routes": k["ssd_routes"], "kernel_s": k["s"], "einsum_s": e["s"],
           "split_margin": margin if peaks else None,
           "tokens_per_s": tokens.numel() / k["s"],
           "peak_bytes": k["peak_bytes"], "first_nonfinite_layer": first,
           "layers_gated": gated,
           "max_rel_layer": max(rel_layers, default=0.0),
           "rel_last_layer": rel_layers[-1] if rel_layers else None}
    if first is None:
        if not (torch.isfinite(k["h"]).all() and torch.isfinite(e["h"]).all()):
            raise AssertionError(f"{cfg.name} float16: non-finite final output")
        out["rel_kernel_vs_einsum_f16"] = rel_err(k["h"], e["h"])
        out["rel_f16_kernel_vs_f32"] = rel_err(k["h"], h_e32)
        out["rel_f16_einsum_vs_f32"] = rel_err(e["h"], h_e32)
    log(f"  prefill {cfg.name} float16 (the bf16 weights cast): kernel path "
        f"{k['s']:.4f} s ({out['tokens_per_s']:.1f} tokens/s, peak "
        f"{k['peak_bytes'] / 2**30:.3f} GiB), einsum path {e['s']:.4f} s; "
        f"launches {k['launches']}, flash routes {k['routes']}, SSD routes "
        f"{k['ssd_routes']}; first non-finite layer {first} (of "
        f"{len(finite['kernel'])}); kernel vs einsum, relative Frobenius "
        f"error per layer up to {out['max_rel_layer']:.4e} over {gated} "
        f"layers (bound {PREFILL_F16_REL_ERR}), final "
        f"{out.get('rel_kernel_vs_einsum_f16')}; against the float32 einsum "
        f"run, kernel path {out.get('rel_f16_kernel_vs_f32')}, einsum path "
        f"{out.get('rel_f16_einsum_vs_f32')} (bound: kernel <= "
        f"{PREFILL_BF16_RATIO} x einsum)")
    bad = [i for i, r in enumerate(rel_layers) if not r <= PREFILL_F16_REL_ERR]
    if bad:
        raise AssertionError(f"{cfg.name} float16: layers {bad} beyond "
                             f"{PREFILL_F16_REL_ERR}: {rel_layers}")
    if first is None and not (
            out["rel_kernel_vs_einsum_f16"] <= PREFILL_F16_REL_ERR
            and out["rel_f16_kernel_vs_f32"]
            <= PREFILL_BF16_RATIO * out["rel_f16_einsum_vs_f32"]):
        raise AssertionError(f"{cfg.name} float16 prefill: {out}")
    return out


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


def near_tie_split(cpu_logits, card_logits, where: str) -> tuple:
    """The first decode step whose greedy tokens differ between the CPU's
    and the card's logits, which must be a near-tie of the CPU's (a top-two
    gap under 2 * (2e-4 + 2e-4 |top|)), or None; and the largest logit
    difference up to it."""
    max_diff = 0.0
    for step, (lc, lg) in enumerate(zip(cpu_logits, card_logits)):
        max_diff = max(max_diff, float((lc - lg).abs().max()))
        rows = torch.nonzero(lc.argmax(-1) != lg.argmax(-1)).flatten()
        if rows.numel():
            for row in rows.tolist():
                top2 = torch.topk(lc[row], 2).values
                gap = float(top2[0] - top2[1])
                if gap >= 2 * (2e-4 + 2e-4 * abs(float(top2[0]))):
                    raise AssertionError(f"{where}: card token differs at "
                                         f"step {step} with a CPU gap {gap}")
            return step, max_diff
    return None, max_diff


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
    first_split, max_diff = near_tie_split(logits["cpu"], logits["card"],
                                           f"reduced {arch}")
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
        half = {name for name, prm in model.named_parameters()
                if prm.dtype == torch.bfloat16}
        t0 = time.perf_counter()
        acc, tokens, h_e32 = prefill_accuracy(model, cfg, p)
        p.update(acc)
        log(f"phase 7 ({arch} prefill in float32): {time.perf_counter() - t0:.2f} s")
        t0 = time.perf_counter()
        # 1 x 4096 (mamba2's first row of its 4 x 4096 prefill)
        p["float16"] = prefill_float16(model, cfg, tokens[:1], h_e32[:1], half)
        del tokens, h_e32
        log(f"phase 7 ({arch} prefill in float16): {time.perf_counter() - t0:.2f} s")
        if cfg.family == "ssm":  # 16-bit on mma_bf16, float32 on mma_tf32
            want = ({"mma_bf16": cfg.num_layers, "mma_tf32": 0},
                    {"mma_bf16": 0, "mma_tf32": cfg.num_layers},
                    {"mma_bf16": cfg.num_layers, "mma_tf32": 0})
            got = (p["ssd_routes"], p["f32_ssd_routes"],
                   p["float16"]["ssd_routes"])
            if got != want:
                raise AssertionError(f"{arch} SSD routes (bf16, float32, "
                                     f"float16) {got}")

        out[arch] = {"params": n_params, "build_s": t_build, "kernel": k,
                     "prefill": p, "serve": s}
        del model
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out["rmsnorm"] = phase_rmsnorm(dev, gen)
    log(f"phase 6 (rmsnorm): {time.perf_counter() - t0:.2f} s")
    t0 = time.perf_counter()
    out["widths"] = phase_widths(dev, gen)
    log(f"phase 6 (widened shapes): {time.perf_counter() - t0:.2f} s")
    return out


# -- phase 9: the paper on the card ----------------------------------------------

PAPER_BUDGET_S = 300.0  # phase 9's aim, so the whole script stays ~10 min
# the whole script's aim, phases 13-15's included (phase 15 takes ~150 s,
# not its 60 s aim: the script then ends near 1,010 s)
SCRIPT_AIM_S = 840.0 + 90.0 + 60.0 + 55.0
# the seconds phases 10-12 took after phase 9 on an H100 at 700 W (phase 10
# ~200 with the law sweep's aim at 50 s and two Fig. 6 streams, plus its
# serving leg's ~17, phase 11 ~35, phase 12 ~101; PERF.md section 5),
# phases 13's and 14's aims (PHASE13_AIM_S, PHASE14_AIM_S), phase 15's
# ~150 and phase 16's ~60: phase 9 aims at what is left of SCRIPT_AIM_S,
# never above PAPER_BUDGET_S (nor below its T floor, where it already is)
LATER_PHASES_S = 353.0 + 90.0 + 60.0 + 150.0 + 60.0
PHASE10_AIM_S = 180.0  # phase 10's aim: the script within ~17 min
LAWS_AIM_S = 40.0  # of which the law sweep's 21 runs (T cut past it; 50
# until phase 16 came)
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
               busy_ms_step: float, aim_s: float = PAPER_BUDGET_S) -> dict:
    """Each figure's T: the paper's, cut only where phase 9's time aim
    ``aim_s`` forces it — Fig. 5's T first, then Fig. 6's, neither below
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

    aim = max(aim_s, estimate(PAPER_MIN_T, PAPER_MIN_T))
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
    # what SCRIPT_AIM_S leaves phase 9 after the phases before it and the
    # expected LATER_PHASES_S
    aim_s = min(PAPER_BUDGET_S,
                SCRIPT_AIM_S - LATER_PHASES_S - (t_phase - T_START))
    plan = paper_plan(fig5_tags, loop["replayed_ms_per_step"], call_s,
                      time.perf_counter() - t_phase, busy_ms_step, aim_s)
    cuts = [f"{fig}: T 40000 -> {plan[key]}"
            for fig, key in (("fig5_sparse_graphs", "fig5_T"),
                             ("fig6_annealing", "fig6_T"))
            if plan[key] < 40_000]
    log(f"  plan: one process, Fig. 5 T={plan['fig5_T']}, Fig. 6 "
        f"T={plan['fig6_T']}, phase 9 estimated {plan['estimate_s']:.0f} s "
        f"(the side-by-side plan, {PAPER_WORKERS} workers sharing the card's "
        f"{plan['device_s']:.0f} s of device time: "
        f"{plan['side_by_side_estimate_s']:.0f} s); aim {aim_s:.0f} s (the "
        f"script's {SCRIPT_AIM_S:.0f} s less {t_phase - T_START:.0f} s spent "
        f"and {LATER_PHASES_S:.0f} s expected after phase 9, at most "
        f"{PAPER_BUDGET_S:.0f} s); T cuts: "
        + ("; ".join(cuts) if cuts else "none"))
    if plan["estimate_s"] > aim_s:
        log(f"  over the {aim_s:.0f} s aim at the least T; the next "
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
FIG6_SEEDS = (1,)  # Fig. 6's stream seeds beyond phase 9's (two until
# phase 16 came)


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
              "cupti_busy_ms": (None if prof["busy_ms"] is None
                                else prof["busy_ms"] / len(pairs)),
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
        f"events, {slot_t['cupti_busy_ms']} ms busy by CUPTI in "
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
    """(d) the fault sweep at its full scale: the training leg's criterion
    beside the reference's, the rescue ordering at 5% gated on both
    families, the "within ~2x" claim reported; the serving leg audited
    (see :class:`ServeAudit`) for phase 12."""
    from repro_torch.paper import fault_sweep

    with open(os.path.join(ROOT, "results", "BENCH_faults.json")) as fh:
        ref = json.load(fh)
    counts_zero(wt)
    t0 = time.perf_counter()
    with ServeAudit(fault_sweep) as audit:
        res = fault_sweep.run(scale="full", device=dev)
    wall = time.perf_counter() - t0
    launches = counts_read(wt)
    legs = 1 + 2 * len(fault_sweep.RATES["full"])
    steps = legs * fault_sweep.SCALES["full"]["steps"]
    sp = fault_sweep.SCALES["full"]["serve"]
    ticks = legs * (sp["ticks"] + sp["drain"])  # the serving leg's ticks
    if (launches["walk_transition_sparse"] != steps
            or launches["walk_transition_ragged"] != steps + ticks):
        raise AssertionError(f"fault sweep: {launches} for {steps} steps a "
                             f"family and {ticks} serving ticks")
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
    # the serving leg is printed and gated with phase 12
    return {"wall_s": wall, "launches": launches, "criterion": crit,
            "reference_criterion": ref["criterion"], "within_2x": within,
            "derived": res["derived"], "gates": gates,
            "serve": res["serve"], "serve_audits": audit.audits,
            "serve_s": sum(a["wall_s"] for a in audit.audits)}


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


# ---------------------------------------------------------------------------
# phase 12: walk-routed serving
# ---------------------------------------------------------------------------

PHASE12_AIM_S = 120.0  # phase 12's aim
# (a) serve_throughput's full routing fabric at mamba2-370m's full width,
# float32 (the reference's default dtype), through the routed CLI's parser
ROUTED_ARGV = ["--arch", "mamba2-370m", "--scale", "full", "--nodes", "100000",
               "--walkers", "512", "--method", "mhlj", "--rate", "2.0",
               "--pickup", "4", "--batch", "8", "--cache-len", "192",
               "--max-queue", "128", "--deadline", "1000", "--max-new", "12",
               "--ticks", "300", "--drain", "100"]
WALL_CLOCK = ("requests_per_sec", "tokens_per_sec", "walk_steps_per_sec")


def serve_records(sim) -> list:
    """Every offered request's ``(rid, node, submit_tick, admit_tick,
    done_tick, shed_reason)``, by rid."""
    e = sim.engine
    reqs = (e.completed + e.shed_requests + e.queue
            + [r for r in e.slots if r is not None]
            + [r for dq in sim.pending.values() for r in dq])
    return sorted((r.rid, r.node, r.submit_tick, r.admit_tick, r.done_tick,
                   r.shed_reason) for r in reqs)


def serve_invariants(sim, m: dict) -> dict:
    """The reference's conservation (``offered == completed + sheds +
    pending_left + queued_left + occupied slots``) and shed-exactly-once
    (no rid both completed and shed, or shed twice) after a run."""
    e = sim.engine
    shed = m["shed_queue_full"] + m["shed_deadline"] + m["shed_node_down"]
    rids = [r.rid for r in e.shed_requests] + [r.rid for r in e.completed]
    accounted = (m["completed"] + shed + m["pending_left"] + m["queued_left"]
                 + sum(r is not None for r in e.slots))
    return {"conserved": accounted == m["offered"],
            "shed_once": (len(rids) == len(set(rids))
                          and shed == len(e.shed_requests))}


class ServeAudit:
    """While open, the ``ServeSimulator`` of each given module (a module
    that imported the class) records, after each ``run``, its metrics,
    invariants, arrival log, fault totals and tick-time split in
    ``audits``; the simulators run unchanged."""

    def __init__(self, *modules):
        self.modules = modules
        self.audits: list = []

    def __enter__(self):
        from repro_torch.launch import serve

        audits = self.audits

        class Audited(serve.ServeSimulator):
            def run(self, num_ticks, drain_ticks=0):
                t0 = time.perf_counter()
                m = super().run(num_ticks, drain_ticks)
                audits.append({
                    "metrics": m, "wall_s": time.perf_counter() - t0,
                    **serve_invariants(self, m),
                    "arrival_log": list(self.arrival_log),
                    "rescues": self.rescues, "ticks": self.ticks,
                    "tick_seconds": dict(self.tick_seconds), "sim": self})
                return m

        self.saved = [(m, m.ServeSimulator) for m in self.modules]
        for m in self.modules:
            m.ServeSimulator = Audited
        return self

    def __exit__(self, *exc):
        for m, cls in self.saved:
            m.ServeSimulator = cls
        for a in self.audits:
            a.pop("sim")  # the engine and its model go with it
        return False


def fmt_split(a: dict) -> str:
    sec = a["tick_seconds"]
    return ", ".join(f"{k} {v / a['ticks'] * 1e3:.3f}"
                     for k, v in sec.items()) + " ms/tick"


def gate(gates: dict, name: str, ok: bool) -> None:
    gates[name] = bool(ok)
    log(f"  gate {name}: {'pass' if ok else 'FAIL'}")


def phase12_routed_main(dev, wt) -> dict:
    """(a) ``launch.serve.main(ROUTED_ARGV)``: BA(100k,3) ragged, W=512,
    MHLJ routing, mamba2-370m at full width in float32, 300 + 100 ticks;
    exit 0, conservation, shed exactly once, one ragged launch a tick."""
    import contextlib
    import io

    from repro_torch.launch import serve

    counts_zero(wt)
    t0 = time.perf_counter()
    with ServeAudit(serve) as audit, contextlib.redirect_stdout(io.StringIO()):
        rc = serve.main(ROUTED_ARGV)
    wall = time.perf_counter() - t0
    launches = counts_read(wt)
    (a,) = audit.audits
    m = a["metrics"]
    log(f"  (a) routed main, mamba2-370m full width float32, BA(100k,3), "
        f"W=512, {a['ticks']} ticks: exit {rc}; offered {m['offered']}, "
        f"completed {m['completed']}, shed queue-full {m['shed_queue_full']} "
        f"deadline {m['shed_deadline']}; {m['requests_per_sec']:.4f} "
        f"requests/s, {m['tokens_per_sec']:.4f} generated tokens/s, "
        f"{m['walk_steps_per_sec']:.6g} walk-steps/s; p50 {m['p50_ticks']} "
        f"p99 {m['p99_ticks']} ticks; herfindahl {m['herfindahl']:.6g}; "
        f"{fmt_split(a)} (route step, host pickup, decode step); "
        f"run {a['wall_s']:.2f} s of {wall:.2f} s; launches {launches}")
    gates: dict = {}
    gate(gates, "(a) exit 0", rc == 0)
    gate(gates, "(a) conservation", a["conserved"])
    gate(gates, "(a) shed exactly once", a["shed_once"])
    gate(gates, "(a) one ragged launch a tick",
         launches["walk_transition_ragged"] == a["ticks"])
    return {"rc": rc, "main_s": wall, "launches": launches, "gates": gates,
            **{k: a[k] for k in ("metrics", "wall_s", "tick_seconds",
                                 "ticks")}}


def phase12_card_vs_cpu(dev, wt) -> dict:
    """(b) reduced mamba2-370m in float32, the same weights on the card and
    on the CPU; BA(2000,3), W=64 at the fault sweep's full serving settings,
    fault-free and under Markov 5%/2%, patience 2, rescue on.  Gate 1: the
    card's generator-driven run == a card run fed the same streams
    injected.  Gate 2: those streams on the CPU give the same visits,
    arrival log, request records and fault totals, and the same greedy
    tokens up to a near-tie (phase 8's rule)."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.faults import FaultModel
    from repro_torch.core.graphs import barabasi_albert
    from repro_torch.launch.serve import ServeEngine, ServeSimulator
    from repro_torch.models.factory import build_model
    from repro_torch.paper import fault_sweep

    sp = fault_sweep.SCALES["full"]["serve"]
    ticks = sp["ticks"] + sp["drain"]
    cfg = reduced(get_arch("mamba2-370m"))
    models = {"cpu": build_model(cfg, torch.float32, device="cpu")}
    models["card"] = build_model(cfg, torch.float32, device=dev)
    models["card"].load_state_dict(models["cpu"].state_dict())
    g = barabasi_albert(sp["n"], sp["m"], seed=0, layout="ragged")

    def simulator(where, fm):
        eng = ServeEngine(cfg, sp["batch"], sp["cache_len"],
                          max_queue=sp["max_queue"], model=models[where],
                          device=models[where].device)
        return ServeSimulator(
            g, eng, method="mhlj", num_walkers=sp["walkers"], rate=sp["rate"],
            pickup=sp["pickup"], deadline_ticks=sp["deadline"],
            prompt_len=sp["prompt_len"], max_new_tokens=sp["max_new"],
            seed=0, fault_model=fm, relocate_after=sp["relocate_after"])

    def recorded_run(sim):
        model, rec = sim.engine.model, []
        decode = model.decode_step

        def recording(tokens, cache, pos):
            out, cache = decode(tokens, cache, pos)
            rec.append(out.cpu())
            return out, cache

        model.decode_step = recording
        try:
            m = sim.run(sp["ticks"], drain_ticks=sp["drain"])
        finally:
            del model.decode_step  # the class's method again
        return m, rec

    def same(a, b, ma, mb, where):
        diff = [k for k in ma if k not in WALL_CLOCK and ma[k] != mb[k]]
        diff += [k for k in ("rescues", "blocked_steps", "relocated",
                             "down_node_ticks")
                 if getattr(a, k) != getattr(b, k)]
        if a.arrival_log != b.arrival_log:
            diff.append("arrival_log")
        if len(a.visits) != len(b.visits) or not all(
                np.array_equal(x, y) for x, y in zip(a.visits, b.visits)):
            diff.append("visits")
        if serve_records(a) != serve_records(b):
            diff.append("records")
        if diff:
            raise AssertionError(f"(b) {where}: the runs differ in {diff}")

    out: dict = {"gates": {}}
    for tag, fm in (("fault_free", None),
                    ("markov_5_2", FaultModel(crash_rate=0.05,
                                              recovery_rate=0.02, patience=2,
                                              rescue=True))):
        counts_zero(wt)
        t0 = time.perf_counter()
        by_gen = simulator("card", fm)
        m_gen = by_gen.run(sp["ticks"], drain_ticks=sp["drain"])
        t_gen = time.perf_counter() - t0
        injected = simulator("card", fm)
        drawn = torch.Generator(device=dev).manual_seed(0)
        streams = injected.draw_streams(ticks, drawn)
        injected.inject(streams)
        m_inj, card_logits = recorded_run(injected)
        launches = counts_read(wt)
        same(by_gen, injected, m_gen, m_inj, f"{tag} generator vs injected")
        if not torch.equal(by_gen.generator.get_state(), drawn.get_state()):
            raise AssertionError(f"(b) {tag}: the generator-driven run drew "
                                 "other streams than draw_streams")
        if ({r.rid: r.generated for r in by_gen.engine.completed}
                != {r.rid: r.generated for r in injected.engine.completed}):
            raise AssertionError(f"(b) {tag}: generator and injected runs "
                                 "generate other tokens on the card")
        gate(out["gates"], f"(b) {tag}: generator-driven == injected on the "
             "card", True)
        t0 = time.perf_counter()
        cpu = simulator("cpu", fm)
        cpu.inject({k: v.cpu() for k, v in streams.items()})
        m_cpu, cpu_logits = recorded_run(cpu)
        t_cpu = time.perf_counter() - t0
        same(injected, cpu, m_inj, m_cpu, f"{tag} card vs CPU")
        split, max_diff = near_tie_split(cpu_logits, card_logits,
                                         f"(b) {tag}")
        if split is None and (
                {r.rid: r.generated for r in cpu.engine.completed}
                != {r.rid: r.generated for r in injected.engine.completed}):
            raise AssertionError(f"(b) {tag}: card and CPU tokens differ")
        gate(out["gates"], f"(b) {tag}: card == CPU on the card's streams",
             True)
        inv = serve_invariants(injected, m_inj)
        gate(out["gates"], f"(b) {tag}: conservation and shed exactly once",
             inv["conserved"] and inv["shed_once"])
        if launches["walk_transition_ragged"] != 2 * ticks:
            raise AssertionError(f"(b) {tag}: {launches} for 2 x {ticks} "
                                 "card ticks")
        log(f"  (b) {tag}, BA(2000,3) W=64 {ticks} ticks: offered "
            f"{m_inj['offered']}, completed {m_inj['completed']}, sheds "
            f"{m_inj['shed_queue_full']}/{m_inj['shed_deadline']}/"
            f"{m_inj['shed_node_down']}, rescues {m_inj['walker_rescues']}, "
            f"relocated {m_inj['relocated_requests']}; tokens card == CPU "
            f"({'all' if split is None else f'until a near-tie at step {split}'}"
            f", max logit difference {max_diff:.3e}); card {t_gen:.2f} s "
            f"({fmt_split({'tick_seconds': by_gen.tick_seconds, 'ticks': ticks})}), "
            f"CPU {t_cpu:.2f} s; launches {launches}")
        out[tag] = {"metrics": m_inj, "card_s": t_gen, "cpu_s": t_cpu,
                    "launches": launches, "tokens_split": split,
                    "max_logit_diff": max_diff,
                    "tick_seconds": dict(by_gen.tick_seconds)}
    return out


P12_SERVE_SCALE = "quick"  # (c)'s tier ("full" until phase 16 came)


def phase12_serve_throughput(dev, wt) -> dict:
    """(c) ``paper.serve_throughput.run(scale=P12_SERVE_SCALE)``: the
    ``quick`` tier, BA(20k,3) ragged, W=128, 400 + 150 ticks (``full``:
    BA(100k,3), W=512, 1500 + 500), the six laws, reduced mamba2-370m.  Gates: each
    law completes requests, conserves them and sheds each once; every
    derived key is there; one ragged launch a tick.  The magnitudes are
    reported, as in the reference."""
    from repro_torch.paper import serve_throughput as st

    with open(os.path.join(ROOT, "results", "BENCH_serve.json")) as fh:
        ref = json.load(fh)
    counts_zero(wt)
    t0 = time.perf_counter()
    with ServeAudit(st) as audit:
        res = st.run(scale=P12_SERVE_SCALE, device=dev)
    wall = time.perf_counter() - t0
    launches = counts_read(wt)
    p = st.SCALES[P12_SERVE_SCALE]
    ticks = p["ticks"] + p["drain"]
    laws = [law[0] for law in st.LAWS]
    gates: dict = {}
    for law, a in zip(laws, audit.audits):
        m = a["metrics"]
        log(f"  (c) {law}: {m['requests_per_sec']:.4f} requests/s, p50 "
            f"{m['p50_ticks']} p99 {m['p99_ticks']} ticks (reference's file "
            f"{ref[law]['p99_ticks']}), herfindahl {m['herfindahl']:.6g} "
            f"(reference's file {ref[law]['herfindahl']:.6g}), top-8 share "
            f"{m['topk_share']:.6g}, {m['walk_steps_per_sec']:.6g} "
            f"walk-steps/s; offered {m['offered']}, completed "
            f"{m['completed']}, shed queue-full {m['shed_queue_full']} "
            f"deadline {m['shed_deadline']}; route set-up "
            f"{res['route_setup_s'][law]:.2f} s; {fmt_split(a)}")
        gate(gates, f"(c) {law}: completes, conserves, sheds once",
             m["completed"] > 0 and a["conserved"] and a["shed_once"])
    want = {f"ba_{law}_{k}" for law in laws
            for k in ("herfindahl", "p99_ticks", "requests_per_sec")}
    gate(gates, "(c) every derived key", set(res["derived"]) == want
         and len(audit.audits) == len(laws))
    gate(gates, "(c) one ragged launch a tick",
         launches["walk_transition_ragged"] == len(laws) * ticks)
    log(f"  (c) serve_throughput {P12_SERVE_SCALE}: {wall:.2f} s, launches {launches}")
    return {"wall_s": wall, "launches": launches, "gates": gates,
            "derived": res["derived"], "route_setup_s": res["route_setup_s"],
            "laws": {law: {"metrics": a["metrics"], "wall_s": a["wall_s"],
                           "tick_seconds": a["tick_seconds"]}
                     for law, a in zip(laws, audit.audits)}}


def phase12_fault_sweep_serving(p10_sweep: dict) -> dict:
    """(d) the fault sweep's serving leg, run inside phase 10 (d): every
    replayed leg offered the fault-free leg's trace, row for row;
    conservation and shed exactly once on every leg; no rescue with it
    off."""
    audits = p10_sweep["serve_audits"]
    legs = list(p10_sweep["serve"])
    trace = audits[0]["arrival_log"]
    gates: dict = {}
    for leg, a in zip(legs, audits):
        m = a["metrics"]
        log(f"  (d) fault sweep serving {leg}: offered {m['offered']} (trace "
            f"rows {len(trace)}), completed {m['completed']}, shed rate "
            f"{p10_sweep['serve'][leg]['shed_rate']:.6g}, p99 "
            f"{m['p99_ticks']} ticks, rescues {m['walker_rescues']}, blocked "
            f"{m['walker_blocked_steps']}, relocated "
            f"{m['relocated_requests']}, downtime "
            f"{m['node_downtime_frac']:.6g}; {a['wall_s']:.2f} s "
            f"({fmt_split(a)})")
        ok = a["conserved"] and a["shed_once"]
        if leg != "fault_free":
            ok = ok and a["arrival_log"] == trace
        if leg.endswith("no_rescue"):
            ok = ok and a["rescues"] == 0
        gate(gates, f"(d) {leg}", ok)
    gate(gates, "(d) every leg", len(audits) == len(legs))
    return {"gates": gates, "legs": {leg: p10_sweep["serve"][leg]
                                     for leg in legs},
            "serve_s": p10_sweep["serve_s"]}


def phase_routed_serving(dev, smi, p10: dict) -> dict:
    """Phase 12: walk-routed serving on the card."""
    from repro_torch.kernels.walk_transition import kernel as wt

    log(f"phase 12 (walk-routed serving): {smi}; aim {PHASE12_AIM_S:.0f} s")
    out: dict = {}
    marks = [time.perf_counter()]
    out["routed_main"] = phase12_routed_main(dev, wt)
    torch.cuda.empty_cache()
    marks.append(time.perf_counter())
    out["card_vs_cpu"] = phase12_card_vs_cpu(dev, wt)
    marks.append(time.perf_counter())
    out["serve_throughput"] = phase12_serve_throughput(dev, wt)
    marks.append(time.perf_counter())
    out["fault_sweep"] = phase12_fault_sweep_serving(p10["fault_sweep"])
    marks.append(time.perf_counter())
    out["part_s"] = dict(zip("abcd", np.diff(marks).tolist()))
    log("  phase 12 parts: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in out["part_s"].items())
        + f"; (d) ran in phase 10: {out['fault_sweep']['serve_s']:.2f} s")
    failed = [k for part in out.values() if isinstance(part, dict)
              for k, ok in part.get("gates", {}).items() if not ok]
    if failed:
        raise AssertionError(f"phase 12: {failed}")
    return out


# -- phase 13: walk-orchestrated LLM training on the card --------------------------

PHASE13_AIM_S = 90.0  # phase 13's aim
TRAIN_ARGV = ["--arch", "mamba2-370m", "--scale", "full", "--graph",
              "watts_strogatz", "--silos", "16", "--method", "mhlj", "--steps",
              "40", "--batch", "4", "--seq", "128", "--device", "cuda"]
# (60 steps until phase 16 came)
P13_DENSE_LAYERS = 2  # minitron-8b's depth cut in (b): 32 -> 2
P13_FLEET = dict(walkers=4, avg_every=5, steps=20)
# (c)'s depth cut: mamba2-370m's 48 layers -> 8, for the phase's time aim
# (a fleet step at full depth is W host-bound train steps; PERF.md 6)
P13_FLEET_LAYERS = 8
P13_CPU_STEPS = 20  # (d): steps of each card run replayed on the CPU
P13_RESUME = dict(steps=40, every=20)  # (e)
P13_LOSS_RTOL = 1e-3  # (d): card against CPU losses, per step
PHASES13 = ("host", "forward_backward", "optimizer", "fingerprint", "advance")


class PhaseTimer:
    """``on_phase`` of ``run_training`` / ``make_train_step``: a CUDA event at
    each phase boundary; :meth:`split` gives the median ms per step of each
    phase after ``skip`` warm-up steps, the interval ending at a phase named
    after it (``host``: the node read and batch fetch, from the step's top),
    and ``loop`` (from the advance to the next step's top: the loss read,
    logging, checkpoints)."""

    def __init__(self):
        self.steps: list = []

    def __call__(self, name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        if name == "step":
            self.steps.append([])
        self.steps[-1].append((name, ev))

    def split(self, skip: int = 2) -> dict:
        torch.cuda.synchronize()
        per: dict = {}
        rows = self.steps[skip:]
        for i, marks in enumerate(rows):
            for (_, a), (name, b) in zip(marks, marks[1:]):
                per.setdefault(name, []).append(a.elapsed_time(b))
            if i + 1 < len(rows):
                per.setdefault("loop", []).append(
                    marks[-1][1].elapsed_time(rows[i + 1][0][1]))
        return {k: float(np.median(v)) for k, v in per.items()}


def fmt_phases(split: dict) -> str:
    return ", ".join(f"{k} {split[k]:.3f}" for k in PHASES13 + ("loop",)
                     if k in split)


class TrainAudit:
    """While open, ``launch.train.run_training`` records each call's result
    and runs under a :class:`PhaseTimer` (the training runs unchanged)."""

    def __init__(self):
        self.runs: list = []

    def __enter__(self):
        from repro_torch.launch import train

        self.saved = train.run_training
        runs, orig = self.runs, train.run_training

        def recorded(*args, **kw):
            timer = PhaseTimer()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            res = orig(*args, **kw, on_phase=timer)
            torch.cuda.synchronize()
            runs.append({"res": res, "wall_s": time.perf_counter() - t0,
                         "split": timer.split(),
                         "peak_gb": torch.cuda.max_memory_allocated() / 1e9})
            return res

        train.run_training = recorded
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train

        train.run_training = self.saved
        return False


def phase13_main(dev, wt) -> dict:
    """(a) ``launch.train.main(TRAIN_ARGV)``: mamba2-370m at full width and
    depth (48 layers, d_model 1024, vocab 50280) in float32, WS(16,4,0.1),
    MHLJ with the online estimator, 40 steps of batch 4 x 128."""
    import contextlib
    import io

    from repro_torch.core.levy import remark1_bound
    from repro_torch.launch import train

    counts_zero(wt)
    out_buf = io.StringIO()
    with TrainAudit() as audit, contextlib.redirect_stdout(out_buf):
        rc = train.main(TRAIN_ARGV)
    launches = counts_read(wt)
    (run,) = audit.runs
    res = run["res"]
    losses = res["losses"]
    steps, batch, seq = (int(TRAIN_ARGV[TRAIN_ARGV.index(f) + 1])
                         for f in ("--steps", "--batch", "--seq"))
    ms_step = sum(v for k, v in run["split"].items())
    bound = remark1_bound(0.1, 0.5, 3)
    first, last = float(losses[:10].mean()), float(losses[-10:].mean())
    lips = res["final_lipschitz"]
    log(f"  (a) train main, mamba2-370m full (48 layers, d_model 1024, vocab "
        f"50280) float32, WS(16,4,0.1), mhlj online, {steps} steps of "
        f"{batch}x{seq}: exit {rc}; loss first 10 {first:.4f}, last 10 "
        f"{last:.4f}; transitions/update {res['transitions_per_update']:.4f} "
        f"(Remark-1 bound {bound:.4f}); {np.unique(lips).size} distinct L_v; "
        f"ms/step {ms_step:.3f} (median by CUDA events: "
        f"{fmt_phases(run['split'])}); {res['steps_per_sec']:.4f} steps/s, "
        f"{res['steps_per_sec'] * batch * seq:.1f} tokens/s; peak "
        f"{run['peak_gb']:.2f} GB; run {run['wall_s']:.2f} s; launches "
        f"{launches}")
    gates: dict = {}
    gate(gates, "(a) exit 0", rc == 0)
    gate(gates, "(a) losses finite", bool(np.isfinite(losses).all()))
    gate(gates, "(a) loss drops", last < first)
    gate(gates, "(a) Remark 1", 1.0 <= res["transitions_per_update"] <= bound + 0.2)
    gate(gates, "(a) L_v spread", np.unique(lips).size > 1)
    gate(gates, "(a) one sparse launch a step",
         launches["walk_transition_sparse"] == steps
         and launches["walk_transition"] == launches["walk_transition_ragged"] == 0)
    return {"rc": rc, "launches": launches, "gates": gates,
            "losses": losses.tolist(), "split_ms": run["split"],
            "ms_per_step": ms_step, "steps_per_sec": res["steps_per_sec"],
            "tokens_per_sec": res["steps_per_sec"] * batch * seq,
            "peak_gb": run["peak_gb"], "wall_s": run["wall_s"],
            "transitions_per_update": res["transitions_per_update"],
            "summary": out_buf.getvalue().splitlines()[-6:]}


def _walk_and_data(arch_cfg, dev, silos=16, seq=128, seed=0, online=True):
    """WS(16,4,0.1), its walk context on ``dev`` and the token shards, as
    ``run_training`` builds them."""
    from repro_torch.core.graphs import watts_strogatz
    from repro_torch.core.transition import MHLJParams
    from repro_torch.data import NodeDataPipeline, make_node_token_shards
    from repro_torch.walk_sgd.llm_trainer import WalkContext

    g = watts_strogatz(silos, 4, 0.1, seed)
    walk = WalkContext.from_graph(g, MHLJParams(0.1, 0.5, 3),
                                  online_lipschitz=online, device=dev)
    data = make_node_token_shards(g.n, arch_cfg.vocab_size,
                                  shard_len=max(2048, (seq + 1) * 4), seed=seed)
    return g, walk, data, NodeDataPipeline


def phase13_dense(dev, wt) -> dict:
    """(b) minitron-8b at full width (d_model 4096, vocab 256000, 32/8 heads,
    d_ff 16384), depth cut to ``P13_DENSE_LAYERS``, float32: every leaf's
    gradient present and nonzero, 10 steps of ``make_train_step`` (AdamW,
    online estimator), and the same step with ``use_kernels=True`` raising
    the kernels' guard without training."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.models.base import param_tree
    from repro_torch.models.factory import build_model
    from repro_torch.optim.base import leaves
    from repro_torch.walk_sgd.llm_trainer import init_walk_state, make_train_step

    full = get_arch("minitron-8b")
    cfg = dataclasses.replace(full, num_layers=P13_DENSE_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, torch.float32, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    params = param_tree(model)
    n_params = sum(x.numel() for x in leaves(params))
    g, walk, data, Pipe = _walk_and_data(cfg, dev)
    pipe = Pipe(data, 2, 128, seed=0)
    state = init_walk_state(g.n, np.ones(g.n, np.float32), device=dev,
                            online=True)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in pipe.next_batch(0).items()}
    loss, _ = model.loss(batch)
    grads = torch.autograd.grad(loss, leaves(params))
    norms = [float(x.norm()) for x in grads]
    del grads, loss
    opt = optim.adamw(3e-4)
    opt_state = opt.init(params)
    step = make_train_step(model, opt, walk)
    counts_zero(wt)
    losses, times = [], []
    for t in range(10):
        t0 = time.perf_counter()
        batch = {k: torch.as_tensor(v, device=dev) for k, v in
                 pipe.next_batch(int(state["node"])).items()}
        params, opt_state, state, m = step(params, opt_state, state, batch)
        losses.append(float(m["loss"]))
        times.append((time.perf_counter() - t0) * 1e3)
    launches = counts_read(wt)
    peak = torch.cuda.max_memory_allocated() / 1e9
    # the same step on the kernel path: the guard raises before any update
    before = [x.clone() for x in leaves(params)[:3]]
    model.cfg = dataclasses.replace(cfg, use_kernels=True)
    raised = ""
    try:
        step(params, opt_state, state, batch)
    except RuntimeError as e:
        raised = str(e)
    model.cfg = cfg
    unchanged = all(torch.equal(a, b) for a, b in zip(before, leaves(params)[:3]))
    ms = float(np.median(times[2:]))
    log(f"  (b) minitron-8b full width, depth cut 32 -> {P13_DENSE_LAYERS} "
        f"layers ({n_params / 1e9:.3f} B parameters) float32, batch 2x128: "
        f"{len(norms)} gradient leaves, smallest norm {min(norms):.4g}; 10 "
        f"steps, losses {losses[0]:.4f} -> {losses[-1]:.4f}; {ms:.2f} ms/step "
        f"(host clock, median of steps 3-10); peak {peak:.2f} GB; "
        f"use_kernels=True: {'raised' if raised else 'did NOT raise'} "
        f"({raised[:60]}...), weights unchanged {unchanged}; launches "
        f"{launches}")
    gates: dict = {}
    gate(gates, "(b) losses finite", bool(np.isfinite(losses).all()))
    gate(gates, "(b) every gradient leaf nonzero", min(norms) > 0
         and all(np.isfinite(norms)))
    gate(gates, "(b) use_kernels under grad raises the guard",
         "no backward" in raised and unchanged)
    gate(gates, "(b) one sparse launch a step",
         launches["walk_transition_sparse"] == 10)
    del model, params, opt_state
    torch.cuda.empty_cache()
    return {"losses": losses, "ms_per_step": ms, "peak_gb": peak,
            "params": n_params, "launches": launches, "gates": gates,
            "grad_norm_min": min(norms)}


def phase13_fleet(dev, wt) -> dict:
    """(c) ``make_multi_walk_step`` on mamba2-370m at full width, its depth
    cut to ``P13_FLEET_LAYERS``, W=4, ``avg_every=5``, 20 steps (AdamW,
    batch 4 x 128 a walker): all W models equal bit for bit after every
    averaging step and different between them; one sparse launch a fleet
    step."""
    import dataclasses

    from repro_torch import optim
    from repro_torch.configs import get_arch
    from repro_torch.models.base import param_tree
    from repro_torch.models.factory import build_model
    from repro_torch.optim.base import leaves
    from repro_torch.walk_sgd.multi_walk import (init_multi_walk_state,
                                                 make_multi_walk_step,
                                                 stack_params)

    w, avg_every, steps = (P13_FLEET[k] for k in ("walkers", "avg_every", "steps"))
    full = get_arch("mamba2-370m")
    cfg = dataclasses.replace(full, num_layers=P13_FLEET_LAYERS)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    model = build_model(cfg, torch.float32, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    tree = param_tree(model)
    opt = optim.adamw(3e-4)
    params_w = stack_params(tree, w)
    opt_w = stack_params(opt.init(tree), w)
    g, walk, data, Pipe = _walk_and_data(cfg, dev, online=False)
    pipes = [Pipe(data, 4, 128, seed=i) for i in range(w)]
    walk_w = init_multi_walk_state(g.n, w, np.ones(g.n, np.float32), seed=0,
                                   device=dev)
    step = make_multi_walk_step(model, opt, walk, avg_every=avg_every)
    counts_zero(wt)
    times, equal_after, losses = [], [], []
    for t in range(steps):
        t0 = time.perf_counter()
        nodes = walk_w["node"].tolist()
        bs = [p.next_batch(v) for p, v in zip(pipes, nodes)]
        batches = {k: torch.as_tensor(np.stack([b[k] for b in bs]), device=dev)
                   for k in ("tokens", "labels")}
        params_w, opt_w, walk_w, m = step(params_w, opt_w, walk_w, batches, t)
        losses.append(m["loss"].tolist())
        times.append((time.perf_counter() - t0) * 1e3)
        same = all(all(torch.equal(x[0], x[i]) for i in range(1, w))
                   for x in leaves(params_w))
        equal_after.append(same)
    launches = counts_read(wt)
    peak = torch.cuda.max_memory_allocated() / 1e9
    want = [(t + 1) % avg_every == 0 for t in range(steps)]
    ms = float(np.median(times[2:]))
    log(f"  (c) fleet, mamba2-370m full width, depth cut {full.num_layers} -> "
        f"{cfg.num_layers} layers (the phase's time aim), W={w}, avg_every="
        f"{avg_every}, {steps} steps of 4x128 a walker: models equal after steps "
        f"{[t for t, s in enumerate(equal_after) if s]} (averaging steps "
        f"{[t for t, s in enumerate(want) if s]}); walker losses at the end "
        f"{[round(x, 4) for x in losses[-1]]}; {ms:.2f} ms/fleet step (host "
        f"clock, median of steps 3-{steps}); peak {peak:.2f} GB; launches "
        f"{launches}")
    gates: dict = {}
    gate(gates, "(c) equal exactly after every average, different between",
         equal_after == want)
    gate(gates, "(c) losses finite", bool(np.isfinite(losses).all()))
    gate(gates, "(c) one sparse launch a fleet step",
         launches["walk_transition_sparse"] == steps)
    del model, tree, params_w, opt_w
    torch.cuda.empty_cache()
    return {"ms_per_step": ms, "peak_gb": peak, "launches": launches,
            "gates": gates, "equal_after": equal_after}


class AdvanceLog:
    """While open, ``WalkContext.advance`` records, per call, the walk's
    node, the block it took and the Lipschitz vector its Eq.-7 row reads."""

    def __init__(self):
        self.calls: list = []

    def __enter__(self):
        from repro_torch.walk_sgd import llm_trainer

        self.saved, calls = llm_trainer.WalkContext.advance, self.calls
        orig = self.saved

        def advance(ctx, state, uniforms=None):
            if uniforms is None:
                uniforms = ctx._block(state["rng"], state.get("p_j", ctx.p_j))
            calls.append((int(state["node"]), uniforms.cpu().numpy().copy(),
                          state["lipschitz"].cpu().numpy().copy()))
            return orig(ctx, state, uniforms)

        llm_trainer.WalkContext.advance = advance
        return self

    def __exit__(self, *exc):
        from repro_torch.walk_sgd import llm_trainer

        llm_trainer.WalkContext.advance = self.saved
        return False


def eq7_margin(graph, lips, node, u_mh) -> float:
    """The smallest gap ``|cdf_j - u*total| / total`` of node's live Eq.-7
    row (float64)."""
    deg = np.asarray(graph.degrees)
    nb = np.asarray(graph.neighbors)[node][:deg[node]]
    move = np.array([0.0 if v == node else
                     min(1.0 / deg[node], lips[v] / (deg[v] * lips[node]))
                     for v in nb], np.float64)
    move[nb == node] = 1.0 - move.sum()
    cdf = np.cumsum(move)
    return float(np.min(np.abs(cdf - u_mh * cdf[-1])) / cdf[-1])


def phase13_card_vs_cpu(dev, wt) -> dict:
    """(d) reduced qwen2.5-32b and reduced mamba2-370m, the same weights
    (built on the CPU from seed 0) and fingerprint projections on both
    devices, ``P13_CPU_STEPS`` steps of ``run_training``: the card draws its
    blocks, the CPU takes them injected.  ``uniform``: nodes and hops bit
    for bit, losses at ``P13_LOSS_RTOL`` per step.  ``mhlj`` (online): nodes
    equal up to the first pick within a near-tie of the live Eq.-7 row
    (its step and margin printed)."""
    from repro_torch import interop
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.engine import draw_uniforms
    from repro_torch.launch import train
    from repro_torch.models.factory import build_model
    from repro_torch.optim.base import leaves
    from repro_torch.models.base import param_tree

    out, gates = {}, {}
    steps = P13_CPU_STEPS
    for arch in ("qwen2.5-32b", "mamba2-370m"):
        cfg = reduced(get_arch(arch))
        base = build_model(cfg, torch.float32, device="cpu",
                           generator=torch.Generator().manual_seed(0))
        init = interop.reference_params_of(base)
        pgen = torch.Generator().manual_seed(0)
        proj = [torch.randn(x.shape, generator=pgen)
                for x in leaves(param_tree(base))]
        for method in ("uniform", "mhlj"):
            kw = dict(graph_kind="watts_strogatz", n_silos=16, method=method,
                      steps=steps, batch_size=2, seq_len=64, log_every=0,
                      seed=0, init_params=init)
            p_j = 0.1 if method == "mhlj" else 0.0
            gen = torch.Generator(dev).manual_seed(0)  # the walk's, as run_training seeds it
            blocks = torch.stack([draw_uniforms(1, 3, p_j, gen, dev)
                                  for _ in range(steps)]).cpu()
            counts_zero(wt)
            with AdvanceLog() as card_log:
                card = train.run_training(
                    cfg, device=dev, projections=[x.to(dev) for x in proj], **kw)
            launches = counts_read(wt)
            cpu = train.run_training(cfg, device="cpu", projections=proj,
                                     uniforms=blocks.numpy(), **kw)
            nc, np_ = card["update_nodes"], cpu["update_nodes"]
            differ = np.nonzero(nc != np_)[0]
            k = int(differ[0]) if differ.size else steps
            rel = np.abs(card["losses"][:k] - cpu["losses"][:k]) / np.abs(cpu["losses"][:k])
            tag = f"{arch}/{method}"
            rec = {"launches": launches, "equal_steps": k,
                   "loss_max_rel": float(rel.max()),
                   "hops_equal": card["transitions_per_update"]
                   == cpu["transitions_per_update"]}
            if k < steps:
                node, u, lips = card_log.calls[k - 1]
                rec["margin"] = eq7_margin(train.GRAPHS["watts_strogatz"](16, 0),
                                           lips, node, float(u[0, 1]))
            out[tag] = rec
            log(f"  (d) {tag} reduced, {steps} steps card vs CPU (card-drawn "
                f"blocks, shared projections): nodes equal for {k} of {steps}"
                + (f" (then a pick at margin {rec['margin']:.3g} of the live "
                   f"Eq.-7 row)" if k < steps else "")
                + f"; transitions/update {card['transitions_per_update']:.3f} "
                f"vs {cpu['transitions_per_update']:.3f}; loss max rel diff "
                f"{rec['loss_max_rel']:.3g}; launches {launches}")
            gate(gates, f"(d) {tag} one sparse launch a step",
                 launches["walk_transition_sparse"] == steps)
            gate(gates, f"(d) {tag} losses at {P13_LOSS_RTOL}",
                 rec["loss_max_rel"] <= P13_LOSS_RTOL)
            if method == "uniform":
                gate(gates, f"(d) {tag} nodes and hops bit for bit",
                     k == steps and rec["hops_equal"])
            else:
                gate(gates, f"(d) {tag} nodes equal up to a near-tie",
                     k == steps or rec["margin"] < 1e-4)
    out["gates"] = gates
    return out


def phase13_resume(dev, wt) -> dict:
    """(e) reduced mamba2-370m, ``P13_RESUME`` steps with a checkpoint every
    20, killed at the top of step 21 and resumed, under
    ``torch.use_deterministic_algorithms(True)`` with
    ``CUBLAS_WORKSPACE_CONFIG=:4096:8``: losses, nodes, parameters,
    optimizer state and walk state equal the uninterrupted run bit for bit.
    ms/step with and without the deterministic mode."""
    return resume_check(dev, wt, "mamba2-370m", P13_RESUME["steps"],
                        P13_RESUME["every"], "(e)")


def resume_check(dev, wt, arch: str, steps: int, every: int, tag: str) -> dict:
    """Reduced ``arch``, ``steps`` steps of 4 x 128 (MHLJ, online) with a
    checkpoint every ``every``, killed at the top of step ``every + 1`` and
    resumed, under deterministic algorithms: bit for bit against the
    uninterrupted run (also run under them), and ms/step without them."""
    import shutil
    import tempfile

    from repro_torch.configs import get_arch, reduced
    from repro_torch.launch import train
    from repro_torch.utils.checkpoint import flatten_with_paths

    class Killed(Exception):
        pass

    cfg = reduced(get_arch(arch))
    kw = dict(graph_kind="watts_strogatz", n_silos=16, method="mhlj",
              steps=steps, batch_size=4, seq_len=128, log_every=0, seed=5,
              device=dev)
    counts_zero(wt)
    t0 = time.perf_counter()
    train.run_training(cfg, **kw)
    torch.cuda.synchronize()
    free_ms = (time.perf_counter() - t0) * 1e3 / steps
    old_env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.use_deterministic_algorithms(True)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="resume_ckpt_", dir=os.path.join(ROOT, "build"))
    try:
        t0 = time.perf_counter()
        full = train.run_training(cfg, **kw)
        torch.cuda.synchronize()
        det_ms = (time.perf_counter() - t0) * 1e3 / steps
        seen = [0]

        def kill_after(name):
            if name == "step":
                if seen[0] == every:
                    raise Killed
                seen[0] += 1

        try:
            train.run_training(cfg, **kw, checkpoint_dir=root,
                               checkpoint_every=every, on_phase=kill_after)
            killed = False
        except Killed:
            killed = True
        resumed = train.run_training(cfg, **kw, checkpoint_dir=root,
                                     checkpoint_every=every, resume=True)
    finally:
        torch.use_deterministic_algorithms(False)
        if old_env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)
        else:
            os.environ["CUBLAS_WORKSPACE_CONFIG"] = old_env
        shutil.rmtree(root, ignore_errors=True)
    launches = counts_read(wt)

    def same(a, b):
        fa, fb = flatten_with_paths(a), flatten_with_paths(b)
        return list(fa) == list(fb) and all(np.array_equal(fa[k], fb[k]) for k in fa)

    checks = {
        "losses": np.array_equal(resumed["losses"], full["losses"][every:]),
        "nodes": np.array_equal(resumed["update_nodes"],
                                full["update_nodes"][every:]),
        "params": same(resumed["params"], full["params"]),
        "opt_state": same(resumed["opt_state"], full["opt_state"]),
        "walk_state": same(resumed["walk_state"], full["walk_state"]),
    }
    log(f"  {tag} reduced {arch}, {steps} steps (4x128), checkpoint every "
        f"{every}, killed at the top of step {every + 1}: {killed}; resumed == "
        f"uninterrupted: {checks}; ms/step {free_ms:.3f} without, "
        f"{det_ms:.3f} with deterministic algorithms (host clock, whole "
        f"run); launches {launches}")
    gates: dict = {}
    gate(gates, f"{tag} killed after the step-{every} checkpoint", killed)
    gate(gates, f"{tag} resume bit for bit", all(checks.values()))
    gate(gates, f"{tag} one sparse launch a step",
         launches["walk_transition_sparse"] == 3 * steps)
    return {"launches": launches, "gates": gates, "checks": checks,
            "ms_per_step": free_ms, "deterministic_ms_per_step": det_ms}


def phase_llm_training(dev, smi) -> dict:
    """Phase 13: walk-orchestrated LLM training on the card."""
    from repro_torch.kernels.walk_transition import kernel as wt

    torch.cuda.empty_cache()
    log(f"phase 13 (LLM training): {smi}; aim {PHASE13_AIM_S:.0f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held by earlier phases")
    out: dict = {}
    marks = [time.perf_counter()]
    for part, fn in (("main", phase13_main), ("dense", phase13_dense),
                     ("fleet", phase13_fleet), ("card_vs_cpu", phase13_card_vs_cpu),
                     ("resume", phase13_resume)):
        out[part] = fn(dev, wt)
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
    out["part_s"] = dict(zip("abcde", np.diff(marks).tolist()))
    log("  phase 13 parts: " + ", ".join(
        f"({k}) {v:.2f} s" for k, v in out["part_s"].items()))
    failed = [k for part in out.values() if isinstance(part, dict)
              for k, ok in part.get("gates", {}).items() if not ok]
    if failed:
        raise AssertionError(f"phase 13: {failed}")
    return out


# -- phase 14: the MoE, hybrid and audio families ------------------------------------

PHASE14_AIM_S = 60.0  # phase 14's aim
JAMBA = "jamba-1.5-large-398b"
# (a) jamba's cuts: one period (72 -> 8 layers), 16 -> 8 experts (the 16
# experts of one period alone are ~77 GB in bf16); 4 if 8 do not fit
P14_JAMBA_EXPERTS = (8, 4)
P14_PREFILL = (1, 4096)  # (a), (b): B x S
P14_WHISPER = (4, 448)  # (c): B x decoder tokens, on 1500 frames
P14_TOL = 2e-4  # (d): card against CPU, atol = rtol
P14_DECODE = 20  # (d): decode steps through a 16-slot cache
P14_CARD_CPU = ("olmoe-1b-7b", "deepseek-moe-16b", JAMBA, "whisper-tiny")
P14_TRAIN_ARGV = ["--arch", "olmoe-1b-7b", "--scale", "full", "--graph",
                  "watts_strogatz", "--silos", "16", "--method", "mhlj",
                  "--steps", "10", "--batch", "2", "--seq", "128", "--device",
                  "cuda"]
# (e) olmoe-1b-7b's depth cut: 16 -> 4 layers (weights, gradients and AdamW
# state in float32: ~28 GB at 4 layers, ~109 GB at 16)
P14_TRAIN_LAYERS = 4
P14_CPU_STEPS = 20  # (e): reduced jamba and deepseek, card against CPU
P14_FLEET = dict(walkers=4, avg_every=2, steps=4)  # (e): reduced olmoe
P14_RESUME = dict(steps=20, every=10)  # (e): reduced olmoe


class MoEAudit:
    """While open, every ``moe_apply`` call's aux and every router call's
    probabilities are recorded (the layer runs unchanged)."""

    def __init__(self):
        self.aux: list = []
        self.probs: list = []

    def __enter__(self):
        from repro_torch.models.layers import moe as moe_mod

        self.saved = (moe_mod.moe_apply, moe_mod.moe_route)
        apply, route = self.saved
        aux, probs = self.aux, self.probs

        def recorded_apply(params, x, dims):
            out, a = apply(params, x, dims)
            aux.append({k: v.detach() for k, v in a.items()})
            return out, a

        def recorded_route(params, x, dims):
            out = route(params, x, dims)
            probs.append((out[0].detach(), dims.experts_per_token))
            return out

        moe_mod.moe_apply, moe_mod.moe_route = recorded_apply, recorded_route
        return self

    def __exit__(self, *exc):
        from repro_torch.models.layers import moe as moe_mod

        moe_mod.moe_apply, moe_mod.moe_route = self.saved
        return False



def moe_summary(aux: list) -> dict:
    """The dropped fraction (mean, and each MoE layer's) and the mean
    expert load over recorded MoE calls."""
    if not aux:
        return {"dropped_frac": None, "dropped_by_layer": None, "expert_load": None}
    drops = torch.stack([a["moe_dropped_frac"] for a in aux])
    load = torch.stack([a["moe_expert_load"] for a in aux]).mean(0)
    return {"dropped_frac": float(drops.mean()),
            "dropped_by_layer": [round(float(x), 4) for x in drops],
            "expert_load": [round(float(x), 4) for x in load]}


def routing_changed(probs_a: list, probs_b: list) -> float:
    """The share of (MoE layer, token) whose selected experts differ between
    two runs' paired router calls."""
    changed = total = 0
    for (pa, k), (pb, _) in zip(probs_a, probs_b):
        ia = torch.sort(pa, dim=-1, descending=True, stable=True).indices[..., :k]
        ib = torch.sort(pb, dim=-1, descending=True, stable=True).indices[..., :k]
        changed += int((ia != ib).any(-1).sum())
        total += ia[..., 0].numel()
    return changed / max(total, 1)


def jamba_ssd(model, cfg, dev, gen) -> dict:
    """``ssd_scan`` on jamba's layer 0 (period 0, mamba sublayer 0): B=1,
    L=4096, H=256, P=64, N=128, G=8, chunk 256, bf16 (the ``mma_bf16``
    route) against its plain version, both routes (float32: the inputs
    upcast) held to the float64 result (no more than twice the plain
    version's error), device times with the share of the bound (B and C
    counted at their 8 groups; the float32 route's operations at a third
    of the TF32 rate), ``ops._head_major``'s copies (a 32-fold group repeat
    of B and C here) timed apart, and the scan with them (the path from
    the model's layout) with its share of the same bound."""
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.kernels.ssd.ref import ssd_scan_ref
    from repro_torch.utils.kernel_bounds import ssd_ops_per_s

    b, l = P14_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (b, l), generator=gen, device=dev)
    dims = model.mdims
    xs, dt, a, bs, cs = ssd_inputs(model, model.periods[0]["mamba"][0], tokens)
    args = ssd_ops._head_major(xs, dt, a, bs, cs)
    chunk, h, p, n = dims.chunk, dims.num_heads, dims.head_dim, dims.d_state
    where = (f"at jamba's layer 0, B={b} L={l} H={h} P={p} N={n} "
             f"G={dims.num_groups} chunk {chunk}")
    before = dict(ssd_ops.ssd_scan.launches_by_route)
    plain_y = ssd_scan_ref(*args, chunk=chunk)
    y = ssd_ops.ssd_scan(*args, chunk=chunk)
    err = hold("ssd_scan", y, plain_y, torch.bfloat16, where + " bf16")
    args32 = tuple(t.float() for t in args)
    y32 = ssd_ops.ssd_scan(*args32, chunk=chunk)
    went = {r: ssd_ops.ssd_scan.launches_by_route[r] - before[r] for r in before}
    if went != {"mma_bf16": 1, "mma_tf32": 1}:
        raise AssertionError(f"ssd_scan took the routes {went} at jamba's shape")
    exact = ssd_scan_ref(*(t.double() for t in args), chunk=chunk)
    top = float(exact.abs().max())
    err64 = {name: float((t.double() - exact).abs().max())
             for name, t in (("mma_bf16", y), ("mma_tf32", y32),
                             ("plain", plain_y))}
    del exact, y32
    f32_ms = device_time_ms(lambda i: ssd_ops.ssd_scan(*args32, chunk=chunk), 10)
    f32_bound = bound(*ssd_bound(b, h, l, p, n, chunk, 4, dims.num_groups),
                      ssd_ops_per_s(4))
    del args32
    log(f"  ssd_scan mma_tf32 {where} (inputs upcast): {f32_ms[0]:.4f} ms/launch "
        f"on the device ({f32_bound[0] / f32_ms[0]:.1%} of its bound "
        f"{f32_bound[0]:.5f} ms by {f32_bound[1]})")
    for route in ("mma_bf16", "mma_tf32"):
        if not err64[route] <= 2 * err64["plain"]:
            raise AssertionError(f"ssd_scan {route} against float64 {where}: {err64}")
    log(f"  ssd_scan max abs err against the float64 result {where} (max |y| "
        f"{top:.3e}): mma_bf16 {err64['mma_bf16']:.3e}, mma_tf32 (inputs "
        f"upcast) {err64['mma_tf32']:.3e}, plain version {err64['plain']:.3e}")
    plain = device_time_ms(lambda i: ssd_scan_ref(*args, chunk=chunk), 3)
    head_major = device_time_ms(lambda i: ssd_ops._head_major(xs, dt, a, bs, cs), 10)
    ms = device_time_ms(lambda i: ssd_ops.ssd_scan(*args, chunk=chunk), 20)
    path = device_time_ms(lambda i: ssd_ops.ssd_scan(
        *ssd_ops._head_major(xs, dt, a, bs, cs), chunk=chunk), 20)
    nbytes, ops = ssd_bound(b, h, l, p, n, chunk, 2, dims.num_groups)
    b_ms, b_by = bound(nbytes, ops, BF16_OPS_PER_S)
    repeat_bytes = 2 * b * h * l * n * 2  # B and C written head-major
    log(f"  ssd_scan mma_bf16 {where}: {ms[0]:.4f} ms/launch on the device "
        f"({b_ms / ms[0]:.1%} of its bound {b_ms:.5f} ms by {b_by}; "
        f"{nbytes:.4e} B with B and C at their {dims.num_groups} groups, "
        f"{ops:.4e} flop), plain {plain[0]:.4f} ms; ops._head_major "
        f"{head_major[0]:.4f} ms ({repeat_bytes / 1e6:.0f} MB of repeated B and C, "
        f"{h // dims.num_groups}-fold); the two together {path[0]:.4f} ms "
        f"({b_ms / path[0]:.1%} of the bound)")
    return {"ms": ms[0], "plain_ms": plain[0], "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bound_share": b_ms / ms[0],
            "max_abs_err": err, "max_abs_err_vs_f64": err64, "max_abs_y": top,
            "head_major_ms": head_major[0], "path_ms": path[0],
            "path_bound_share": b_ms / path[0], "bytes": nbytes, "ops": ops,
            "f32": {"ms": f32_ms[0], "bound_ms": f32_bound[0],
                    "bound_by": f32_bound[1],
                    "bound_share": f32_bound[0] / f32_ms[0]},
            "shape": {"b": b, "l": l, "h": h, "p": p, "n": n,
                      "g": dims.num_groups, "chunk": chunk}}


def prefill14(model, cfg, dev, gen) -> dict:
    """Prefill at ``P14_PREFILL`` in bf16 on both paths (``both_paths``,
    after a warm call): tokens/s, peak memory, the relative Frobenius error
    of the kernel path against the einsum path, and the MoE layers'
    dropped fraction and expert load on the kernel path."""
    import dataclasses

    b, s = P14_PREFILL
    tokens = torch.randint(0, cfg.vocab_size, (b, s), generator=gen, device=dev)
    model.cfg = dataclasses.replace(cfg, use_kernels=True)
    model.apply({"tokens": tokens})  # warm
    with MoEAudit() as audit:
        runs = both_paths(model, cfg, tokens)
    half = len(audit.probs) // 2  # the kernel path's calls, then the einsum path's
    rel = rel_err(runs["kernel"]["h"], runs["einsum"]["h"])
    k, e = runs["kernel"], runs["einsum"]
    out = {"batch": b, "seq": s, "tokens_per_s": b * s / k["s"],
           "einsum_tokens_per_s": b * s / e["s"], "kernel_s": k["s"],
           "einsum_s": e["s"], "peak_gb": k["peak_bytes"] / 1e9,
           "einsum_peak_gb": e["peak_bytes"] / 1e9, "rel_kernel_vs_einsum": rel,
           "launches": k["launches"], "routes": k["routes"],
           "ssd_routes": k["ssd_routes"],
           "routing_changed": routing_changed(audit.probs[:half], audit.probs[half:]),
           **moe_summary(audit.aux[:half])}
    log(f"  prefill {cfg.name} B={b} S={s} bf16: kernel path {k['s']:.4f} s "
        f"({out['tokens_per_s']:.1f} tokens/s, peak {out['peak_gb']:.2f} GB), "
        f"einsum path {e['s']:.4f} s ({out['einsum_tokens_per_s']:.1f} tokens/s, "
        f"peak {out['einsum_peak_gb']:.2f} GB); relative Frobenius error kernel "
        f"vs einsum {rel:.4e}; launches {k['launches']}, SSD routes "
        f"{k['ssd_routes']}; MoE dropped fraction {out['dropped_frac']} (by "
        f"layer {out['dropped_by_layer']}), expert load {out['expert_load']}; "
        f"tokens routed differently by the two paths {out['routing_changed']:.4%}")
    return out


def build14(cfg, dev, dtype=torch.bfloat16):
    """``cfg``'s model from seed 0 on the card: the model, its parameter
    count and build seconds."""
    from repro_torch.models.factory import build_model

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    model = build_model(cfg, dtype, device=dev,
                        generator=torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in model.parameters())
    return model, n, time.perf_counter() - t0


def phase14_jamba(dev, smi) -> dict:
    """(a) jamba-1.5-large-398b at full width, one period, its experts cut
    (``P14_JAMBA_EXPERTS``): ``ssd_scan`` on layer 0's inputs, the prefill
    on both paths (7 ``mma_bf16`` launches, no flash launch: the reference's
    hybrid attention is einsum), then ``ServeEngine`` on the 8 requests."""
    import dataclasses

    from repro_torch.configs import get_arch

    full = get_arch(JAMBA)
    gates: dict = {}
    for experts in P14_JAMBA_EXPERTS:
        cfg = dataclasses.replace(full, num_layers=full.attn_period,
                                  num_experts=experts)
        try:
            model, n, t_build = build14(cfg, dev)
            c = model.counts
            log(f"  (a) {JAMBA}, {smi}: cuts: layers {full.num_layers} -> "
                f"{cfg.num_layers} (one period: {c['mamba']} mamba, 1 attention, "
                f"{c['moe']} MoE, {c['mlp']} SwiGLU), experts {full.num_experts} "
                f"-> {experts} (top-{cfg.experts_per_token} kept); width uncut "
                f"(d_model {cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} "
                f"heads, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, SSD "
                f"{cfg.ssm_heads} heads, P={cfg.ssm_head_dim}, N={cfg.ssm_state}, "
                f"{cfg.ssm_groups} groups); {n} parameters, {n * 2 / 1e9:.2f} GB "
                f"in bf16, built in {t_build:.2f} s")
            gen = torch.Generator(device=dev).manual_seed(0)
            kernel = jamba_ssd(model, cfg, dev, gen)
            pre = prefill14(model, cfg, dev, gen)
            break
        except torch.cuda.OutOfMemoryError as e:
            model = None
            torch.cuda.empty_cache()
            if experts == P14_JAMBA_EXPERTS[-1]:
                raise
            log(f"  (a) {JAMBA} with {experts} experts ran out of device "
                f"memory ({str(e)[:120]}); cutting to the next count")
    gate(gates, "(a) 7 mma_bf16 ssd_scan launches, no other kernel",
         pre["ssd_routes"] == {"mma_bf16": 7, "mma_tf32": 0}
         and pre["launches"] == {"flash_attention": 0, "ssd_scan": 7,
                                 "rmsnorm_fused": 0})
    srv = serve(model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    return {"experts": cfg.num_experts, "params": n, "build_s": t_build,
            "kernel": kernel, "prefill": pre, "serve": srv, "gates": gates}


def phase14_deepseek(dev, smi) -> dict:
    """(b) deepseek-moe-16b at full width and depth: the prefill (both paths
    must give the same bits: ``use_kernels`` changes nothing on the MoE
    family, whose attention is einsum in the reference) and serving."""
    from repro_torch.configs import get_arch

    cfg = get_arch("deepseek-moe-16b")
    model, n, t_build = build14(cfg, dev)
    log(f"  (b) deepseek-moe-16b full ({cfg.num_layers} layers, the first "
        f"dense, {cfg.num_experts} experts top-{cfg.experts_per_token}, "
        f"{cfg.num_shared_experts} shared), {smi}: {n} parameters, "
        f"{n * 2 / 1e9:.2f} GB in bf16, built in {t_build:.2f} s")
    gen = torch.Generator(device=dev).manual_seed(0)
    pre = prefill14(model, cfg, dev, gen)
    gates: dict = {}
    gate(gates, "(b) no kernel launched, use_kernels changes no bit",
         pre["rel_kernel_vs_einsum"] == 0.0 and not any(pre["launches"].values()))
    srv = serve(model, cfg, dev)
    del model
    torch.cuda.empty_cache()
    return {"params": n, "build_s": t_build, "prefill": pre, "serve": srv,
            "gates": gates}


def phase14_whisper(dev, smi) -> dict:
    """(c) whisper-tiny at full size: ``apply`` on B=4 x (1500 frames, 448
    tokens) (tokens/s over the decoder tokens), ``init_cache`` with frames
    equal to ``precompute_cross_kv`` on the encoder's output, serving."""
    from repro_torch.configs import get_arch
    from repro_torch.models.layers import attention as attn_mod

    cfg = get_arch("whisper-tiny")
    model, n, t_build = build14(cfg, dev)
    b, s = P14_WHISPER
    gen = torch.Generator(device=dev).manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=gen,
                                     device=dev),
             "frames": torch.randn((b, cfg.encoder_len, cfg.d_model),
                                   generator=gen, device=dev)}
    model.apply(batch)  # warm
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    h = model.apply(batch)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 1e9
    cache = model.init_cache(b, 256, frames=batch["frames"])
    with torch.no_grad():
        memory = model.encode(batch["frames"])
        same = all(torch.equal(kv["k"], want["k"]) and torch.equal(kv["v"], want["v"])
                   for layer, kv in zip(model.decoder, cache["cross"])
                   for want in [attn_mod.precompute_cross_kv(layer["cross_attn"],
                                                             memory, model.dims)])
    log(f"  (c) whisper-tiny full ({cfg.num_encoder_layers}+{cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, {cfg.encoder_len} frames), {smi}: {n} "
        f"parameters; apply B={b} x ({cfg.encoder_len} frames, {s} tokens) bf16 "
        f"{dt:.4f} s ({b * s / dt:.1f} decoder tokens/s, {b * cfg.encoder_len / dt:.1f} "
        f"frames/s), peak {peak:.3f} GB; init_cache cross K/V == "
        f"precompute_cross_kv(encode(frames)): {same}")
    gates: dict = {}
    gate(gates, "(c) apply finite, (B, S, D)", bool(torch.isfinite(h).all())
         and tuple(h.shape) == (b, s, cfg.d_model))
    gate(gates, "(c) init_cache's cross K/V", same)
    srv = serve(model, cfg, dev)
    del model, cache, memory
    torch.cuda.empty_cache()
    return {"params": n, "apply_s": dt, "tokens_per_s": b * s / dt,
            "peak_gb": peak, "serve": srv, "gates": gates}


def routing_near_ties(cpu_probs, card_probs) -> tuple:
    """Tokens whose k-th and (k+1)-th router probabilities (the CPU's) lie
    closer than the card's largest difference from the CPU's, over paired
    router calls; and that difference.  Printed apart: they excuse
    nothing."""
    ties, diff = 0, 0.0
    for (pc, k), (pg, _) in zip(cpu_probs, card_probs):
        d = float((pc - pg.cpu()).abs().max())
        diff = max(diff, d)
        top = torch.sort(pc.reshape(-1, pc.shape[-1]), dim=-1,
                         descending=True).values
        ties += int(((top[:, k - 1] - top[:, k]) <= d).sum())
    return ties, diff


def routing_split(cpu_probs, card_probs, marks: list, where: str):
    """The first decode step (its router calls ``marks[t]:marks[t + 1]``)
    at which the card selects other experts than the CPU for a token, which
    must be a near-tie of the CPU's router probabilities (the k-th and
    (k+1)-th within 2 * (P14_TOL + P14_TOL * p_k)), or None."""
    for step in range(len(marks) - 1):
        calls = zip(cpu_probs[marks[step]:marks[step + 1]],
                    card_probs[marks[step]:marks[step + 1]])
        for (pc, k), (pg, _) in calls:
            pc, pg = pc.reshape(-1, pc.shape[-1]), pg.cpu().reshape(-1, pc.shape[-1])
            top = torch.sort(pc, dim=-1, descending=True, stable=True)
            picked = torch.sort(pg, dim=-1, descending=True, stable=True).indices
            rows = torch.nonzero((top.indices[:, :k].sort(-1).values
                                  != picked[:, :k].sort(-1).values).any(-1)).flatten()
            for row in rows.tolist():
                pk = float(top.values[row, k - 1])
                gap = pk - float(top.values[row, k])
                if gap >= 2 * (P14_TOL + P14_TOL * pk):
                    raise AssertionError(f"{where}: card routes a token to other "
                                         f"experts at decode step {step} with a CPU "
                                         f"gap {gap}")
            if rows.numel():
                return step
    return None


def close14(a, b) -> bool:
    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    return bool(((a - b).abs() <= P14_TOL + P14_TOL * b.abs()).all())


def phase14_card_vs_cpu(dev) -> dict:
    """(d) reduced olmoe, deepseek-moe-16b, jamba and whisper in float32 on
    the same weights (built on the CPU from seed 0): ``apply``, ``loss``
    with its aux and ``P14_DECODE`` decode steps through a 16-slot cache at
    ``P14_TOL``; greedy tokens equal up to a near-tie of the CPU's logits,
    and the decode compared up to the first step that routes a token to
    other experts at a near-tie of the CPU's router probabilities
    (``routing_split``); every router call before it within ``P14_TOL`` of
    the CPU's.  Routing near-ties (the k-th and (k+1)-th router
    probabilities closer than the card's difference) are counted and
    printed apart; they excuse nothing.  jamba also on its kernel path
    (``mma_tf32`` on the card, the plain version on the CPU)."""
    import dataclasses

    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.factory import build_model

    out, gates = {}, {}
    for arch in P14_CARD_CPU:
        cfg = reduced(get_arch(arch))
        cpu_model = build_model(cfg, torch.float32, device="cpu")
        card_model = build_model(cfg, torch.float32, device=dev)
        card_model.load_state_dict(cpu_model.state_dict())
        rng = np.random.default_rng(0)
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 64)))
        batch = {"tokens": tokens, "labels": torch.roll(tokens, -1, 1)}
        if cfg.family == "audio":
            batch["frames"] = torch.from_numpy(rng.standard_normal(
                (2, cfg.encoder_len, cfg.d_model)).astype(np.float32))
        res, audits, marks = {}, {}, {}
        for name, m in (("cpu", cpu_model), ("card", card_model)):
            b = {k: v.to(m.device) for k, v in batch.items()}
            paths = [False, True] if cfg.family == "hybrid" else [False]
            with MoEAudit() as audit:
                h = {}
                for uk in paths:
                    m.cfg = dataclasses.replace(cfg, use_kernels=uk)
                    h[uk] = m.apply(b)
                m.cfg = cfg
                loss, aux = m.loss(b)
                frames = b.get("frames")
                cache = (m.init_cache(2, 16, frames=frames) if frames is not None
                         else m.init_cache(2, 16))
                logits, marks[name] = [], []
                for pos in range(P14_DECODE):
                    marks[name].append(len(audit.probs))
                    lg, cache = m.decode_step(b["tokens"][:, pos:pos + 1], cache, pos)
                    logits.append(lg.cpu())
                marks[name].append(len(audit.probs))
            res[name] = {"h": h, "loss": loss, "aux": aux, "logits": logits}
            audits[name] = audit.probs
        if marks["cpu"] != marks["card"]:
            raise AssertionError(f"reduced {arch}: router calls {marks}")
        c, g = res["cpu"], res["card"]
        rsplit = routing_split(audits["cpu"], audits["card"], marks["cpu"],
                               f"reduced {arch}")
        upto = P14_DECODE if rsplit is None else rsplit
        calls = marks["cpu"][upto]  # the router calls before the routing split
        ties, rdiff = routing_near_ties(audits["cpu"][:calls], audits["card"][:calls])
        split, ldiff = near_tie_split(c["logits"][:upto], g["logits"][:upto],
                                      f"reduced {arch}")
        stop = upto if split is None else split
        ok = {f"apply{'_kernels' if uk else ''}": close14(g["h"][uk], c["h"][uk])
              for uk in c["h"]}
        ok["loss"] = close14(g["loss"], c["loss"])
        ok.update({f"aux {k}": close14(g["aux"][k], c["aux"][k]) for k in c["aux"]})
        ok["decode"] = all(close14(a, b) for a, b in
                           zip(g["logits"][:stop], c["logits"][:stop]))
        ok["router"] = rdiff <= P14_TOL
        rec = {"close": ok, "routing_near_ties": ties, "routing_max_diff": rdiff,
               "routing_split_step": rsplit, "token_split_step": split,
               "max_logit_diff": ldiff, "aux_keys": sorted(c["aux"])}
        out[arch] = rec
        log(f"  (d) reduced {arch} float32 card vs CPU (atol = rtol = "
            f"{P14_TOL}): {ok}; greedy tokens "
            f"{'equal on all ' + str(upto) + ' steps' if split is None else f'equal until a near-tie at step {split}'}"
            f"{'' if rsplit is None else f' (decode compared up to a routing near-tie at step {rsplit})'}"
            f" (max logit diff {ldiff:.3e}); routing near-ties {ties} (card vs CPU "
            f"router probabilities within {rdiff:.3e}); aux {sorted(c['aux'])}")
        gate(gates, f"(d) {arch} card == CPU at {P14_TOL}", all(ok.values()))
        if cfg.num_experts:
            gate(gates, f"(d) {arch} loss carries moe_aux", "moe_aux" in c["aux"])
        del cpu_model, card_model
    torch.cuda.empty_cache()
    out["gates"] = gates
    return out


class DepthCut:
    """While open, ``launch.train``'s ``get_arch(arch)`` gives the config at
    ``layers`` layers (the CLI's ``--scale full`` at a cut depth)."""

    def __init__(self, arch: str, layers: int):
        self.arch, self.layers = arch, layers

    def __enter__(self):
        import dataclasses

        from repro_torch.launch import train

        self.saved = train.get_arch
        orig, arch, layers = self.saved, self.arch, self.layers
        train.get_arch = lambda name: (dataclasses.replace(orig(name), num_layers=layers)
                                       if name == arch else orig(name))
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train

        train.get_arch = self.saved
        return False


class StepMetrics:
    """While open, ``launch.train``'s train steps record their metrics."""

    def __init__(self):
        self.metrics: list = []

    def __enter__(self):
        from repro_torch.launch import train

        self.saved = train.make_train_step
        orig, rec = self.saved, self.metrics

        def make(*args, **kw):
            step = orig(*args, **kw)

            def recorded(*a, **k):
                out = step(*a, **k)
                rec.append({key: float(v) for key, v in out[3].items()})
                return out

            return recorded

        train.make_train_step = make
        return self

    def __exit__(self, *exc):
        from repro_torch.launch import train

        train.make_train_step = self.saved
        return False


def phase14_train_main(dev, wt, smi) -> dict:
    """(e) ``launch.train.main(P14_TRAIN_ARGV)``: olmoe-1b-7b at full width,
    depth cut to ``P14_TRAIN_LAYERS``, float32, 10 steps of 2 x 128, MHLJ
    online: ms/step split by phase, peak memory; finite losses, ``moe_aux``
    in every step's metrics, one sparse launch a step."""
    import contextlib
    import io

    from repro_torch.launch import train

    counts_zero(wt)
    buf = io.StringIO()
    with TrainAudit() as audit, StepMetrics() as sm, \
            DepthCut("olmoe-1b-7b", P14_TRAIN_LAYERS), contextlib.redirect_stdout(buf):
        rc = train.main(P14_TRAIN_ARGV)
    launches = counts_read(wt)
    (run,) = audit.runs
    losses = run["res"]["losses"]
    steps, batch, seq = 10, 2, 128
    ms_step = sum(run["split"].values())
    aux = [m.get("moe_aux") for m in sm.metrics]
    log(f"  (e) train main, olmoe-1b-7b full width (d_model 2048, 64 experts "
        f"top-8, vocab 50304), depth cut 16 -> {P14_TRAIN_LAYERS}, float32, "
        f"{smi}, {steps} steps of {batch}x{seq}: exit {rc}; losses "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; moe_aux {aux[0]} -> {aux[-1]}; "
        f"ms/step {ms_step:.3f} (median by CUDA events: {fmt_phases(run['split'])}); "
        f"{run['res']['steps_per_sec'] * batch * seq:.1f} tokens/s; peak "
        f"{run['peak_gb']:.2f} GB; launches {launches}")
    gates: dict = {}
    gate(gates, "(e) train main exit 0", rc == 0)
    gate(gates, "(e) train main losses finite", bool(np.isfinite(losses).all()))
    gate(gates, "(e) moe_aux in every step's metrics",
         len(aux) == steps and all(a is not None and np.isfinite(a) for a in aux))
    gate(gates, "(e) one sparse launch a step",
         launches["walk_transition_sparse"] == steps)
    return {"rc": rc, "launches": launches, "gates": gates,
            "losses": losses.tolist(), "moe_aux": aux, "split_ms": run["split"],
            "ms_per_step": ms_step, "tokens_per_sec":
            run["res"]["steps_per_sec"] * batch * seq, "peak_gb": run["peak_gb"]}


def phase14_train_card_vs_cpu(dev, wt) -> dict:
    """(e) reduced jamba and deepseek-moe-16b, ``P14_CPU_STEPS`` steps of
    ``run_training`` (``uniform``: static L) on the same weights: the card
    draws its blocks, the CPU takes them injected; nodes equal, losses
    within ``P13_LOSS_RTOL``."""
    from repro_torch import interop
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.engine import draw_uniforms
    from repro_torch.launch import train
    from repro_torch.models.factory import build_model

    out, gates, steps = {}, {}, P14_CPU_STEPS
    for arch in (JAMBA, "deepseek-moe-16b"):
        cfg = reduced(get_arch(arch))
        base = build_model(cfg, torch.float32, device="cpu")
        kw = dict(graph_kind="watts_strogatz", n_silos=16, method="uniform",
                  steps=steps, batch_size=2, seq_len=64, log_every=0, seed=0,
                  init_params=interop.reference_params_of(base))
        gen = torch.Generator(dev).manual_seed(0)  # the walk's, as run_training seeds it
        blocks = torch.stack([draw_uniforms(1, 3, 0.0, gen, dev)
                              for _ in range(steps)]).cpu()
        counts_zero(wt)
        t0 = time.perf_counter()
        card = train.run_training(cfg, device=dev, **kw)
        torch.cuda.synchronize()
        card_ms = (time.perf_counter() - t0) * 1e3 / steps
        launches = counts_read(wt)
        cpu = train.run_training(cfg, device="cpu", uniforms=blocks.numpy(), **kw)
        nodes_equal = np.array_equal(card["update_nodes"], cpu["update_nodes"])
        rel = float((np.abs(card["losses"] - cpu["losses"])
                     / np.abs(cpu["losses"])).max())
        out[arch] = {"launches": launches, "nodes_equal": nodes_equal,
                     "loss_max_rel": rel, "card_ms_per_step": card_ms}
        log(f"  (e) reduced {arch}, {steps} steps card vs CPU (card-drawn "
            f"blocks): nodes equal {nodes_equal}; loss max rel diff {rel:.3g}; "
            f"card {card_ms:.2f} ms/step (host clock, whole run); launches "
            f"{launches}")
        gate(gates, f"(e) {arch} nodes equal, losses at {P13_LOSS_RTOL}",
             nodes_equal and rel <= P13_LOSS_RTOL)
        gate(gates, f"(e) {arch} one sparse launch a step",
             launches["walk_transition_sparse"] == steps)
    out["gates"] = gates
    return out


def phase14_fleet(dev, wt) -> dict:
    """(e) reduced olmoe, the fleet step (W=4, ``avg_every``=2): the W models
    equal bit for bit after each averaging step and different between;
    ``moe_aux`` in the metrics; one sparse launch a fleet step."""
    from repro_torch import optim
    from repro_torch.configs import get_arch, reduced
    from repro_torch.models.base import param_tree
    from repro_torch.models.factory import build_model
    from repro_torch.optim.base import leaves
    from repro_torch.walk_sgd.multi_walk import (init_multi_walk_state,
                                                 make_multi_walk_step,
                                                 stack_params)

    w, avg_every, steps = (P14_FLEET[k] for k in ("walkers", "avg_every", "steps"))
    cfg = reduced(get_arch("olmoe-1b-7b"))
    model = build_model(cfg, torch.float32, device=dev,
                        generator=torch.Generator(dev).manual_seed(0))
    tree = param_tree(model)
    opt = optim.adamw(3e-4)
    params_w, opt_w = stack_params(tree, w), stack_params(opt.init(tree), w)
    g, walk, data, Pipe = _walk_and_data(cfg, dev, online=False)
    pipes = [Pipe(data, 2, 64, seed=i) for i in range(w)]
    walk_w = init_multi_walk_state(g.n, w, np.ones(g.n, np.float32), seed=0,
                                   device=dev)
    step = make_multi_walk_step(model, opt, walk, avg_every=avg_every)
    counts_zero(wt)
    equal_after, aux = [], []
    for t in range(steps):
        bs = [p.next_batch(v) for p, v in zip(pipes, walk_w["node"].tolist())]
        batches = {k: torch.as_tensor(np.stack([b[k] for b in bs]), device=dev)
                   for k in ("tokens", "labels")}
        params_w, opt_w, walk_w, m = step(params_w, opt_w, walk_w, batches, t)
        aux.append(m["moe_aux"].tolist())
        equal_after.append(all(all(torch.equal(x[0], x[i]) for i in range(1, w))
                               for x in leaves(params_w)))
    launches = counts_read(wt)
    want = [(t + 1) % avg_every == 0 for t in range(steps)]
    log(f"  (e) fleet, reduced olmoe, W={w}, avg_every={avg_every}, {steps} steps: "
        f"models equal after steps {[t for t, s in enumerate(equal_after) if s]} "
        f"(averaging steps {[t for t, s in enumerate(want) if s]}); moe_aux at "
        f"the end {[round(x, 4) for x in aux[-1]]}; launches {launches}")
    gates: dict = {}
    gate(gates, "(e) fleet equal exactly after every average, different between",
         equal_after == want)
    gate(gates, "(e) fleet one sparse launch a step",
         launches["walk_transition_sparse"] == steps)
    del model, tree, params_w, opt_w
    return {"launches": launches, "gates": gates, "equal_after": equal_after,
            "moe_aux": aux}


def phase_families(dev, smi) -> dict:
    """Phase 14: the MoE, hybrid and audio families on the card."""
    from repro_torch.kernels.walk_transition import kernel as wt

    torch.cuda.empty_cache()
    log(f"phase 14 (MoE, hybrid, audio): {smi}; aim {PHASE14_AIM_S:.0f} s; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB held by earlier phases")
    out: dict = {}
    marks = [time.perf_counter()]
    for part, fn in (("jamba", lambda: phase14_jamba(dev, smi)),
                     ("deepseek", lambda: phase14_deepseek(dev, smi)),
                     ("whisper", lambda: phase14_whisper(dev, smi)),
                     ("card_vs_cpu", lambda: phase14_card_vs_cpu(dev)),
                     ("train_main", lambda: phase14_train_main(dev, wt, smi)),
                     ("train_card_vs_cpu", lambda: phase14_train_card_vs_cpu(dev, wt)),
                     ("fleet", lambda: phase14_fleet(dev, wt)),
                     ("resume", lambda: resume_check(
                         dev, wt, "olmoe-1b-7b", P14_RESUME["steps"],
                         P14_RESUME["every"], "(e)"))):
        out[part] = fn()
        torch.cuda.empty_cache()
        marks.append(time.perf_counter())
    out["part_s"] = dict(zip(list(out), np.diff(marks).tolist()))
    log("  phase 14 parts: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["part_s"].items()))
    failed = [k for part in out.values() if isinstance(part, dict)
              for k, ok in part.get("gates", {}).items() if not ok]
    if failed:
        raise AssertionError(f"phase 14: {failed}")
    return out


# -- phase 15: the walker fleet across ranks ------------------------------------

PHASE15_AIM_S = 60.0  # phase 15's aim
P15_GRAPH = (100_000, 3)  # (a), (b): BA(n, m), phase 3's graph
P15_TRAIN = dict(walkers=2048, avg_every=50, steps=500)  # (a): phase 3's trainer
P15_SWEEP_WALKS, P15_SWEEP_STEPS = (2048, 8192), 200  # (b): the fleet rows, full
P15_CONV = dict(steps=20_000, walkers=(1, 2, 4, 8), avg_every=50)  # (b)
P15_RANKS = (2, 4)  # (c): processes on the one card, over gloo
P15_RANK_STEPS, P15_ODD_STEPS = 200, 50  # (c): the trainer's loop, W + 1 walkers
P15_FAULTS = dict(crash_rate=0.05, recovery_rate=0.02, patience=2,
                  rescue=True)  # (c): phase 10's Markov faults
P15_LLM = dict(archs=("olmoe-1b-7b", "mamba2-370m"), walkers=4, avg_every=2,
               steps=4, lr=1e-3)  # (e)
P15_JOIN_S, P15_PROBE_S = 240.0, 60.0  # a spawn group's limit; the NCCL probe's
P15_COLLECTIVES = 200  # all-reduces of a (dim,) vector timed on each backend


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def spawn_ranks(fn, world: int, args: tuple, limit: float, *,
                fail: bool = True) -> bool:
    """``fn(rank, world, *args)`` in ``world`` spawned processes, joined
    within ``limit`` seconds.  A rank that raises raises here; on expiry
    the ranks are killed and this raises, or with ``fail=False`` returns
    False."""
    import torch.multiprocessing as tmp

    ctx = tmp.start_processes(fn, args=(world, *args), nprocs=world,
                              join=False, start_method="spawn")
    deadline = time.monotonic() + limit
    while not ctx.join(timeout=max(0.0, deadline - time.monotonic())):
        if time.monotonic() >= deadline:
            for p in ctx.processes:
                p.kill()
            for p in ctx.processes:
                p.join(10)
            if fail:
                raise AssertionError(f"{world} ranks did not finish in "
                                     f"{limit:.0f} s")
            return False
    return True


def mesh_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` of every rank of the walker mesh, concatenated (``x`` itself
    without a mesh)."""
    import torch.distributed as dist

    if mesh is None:
        return x
    group = mesh.get_group("data")
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return torch.cat(parts)


def collective_ms(mesh, dev, dim: int) -> float:
    """Milliseconds of one all-reduce of a ``(dim,)`` float32 vector on the
    card along the walker mesh, eager, averaged over P15_COLLECTIVES (host
    clock around a synchronised run: gloo stages through the host)."""
    import torch.distributed as dist

    group = mesh.get_group("data")
    x = torch.ones(dim, device=dev)
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(P15_COLLECTIVES):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / P15_COLLECTIVES


def p15_runs(inp: dict, dev, mesh, wt) -> tuple:
    """(c)'s runs of (a)'s trainer loop from its inputs (``inp``: the
    engine's CSR state and CDF, the data, gamma, the p_J schedule):
    plain and under Markov faults for P15_RANK_STEPS, and W + 1 walkers
    (which no rank count of (c) divides) for P15_ODD_STEPS; each fleet
    seeded 0, each generator 15.  Returns the whole fleet's outputs
    (numpy) and each run's seconds, ragged launches and capture."""
    from repro_torch import interop
    from repro_torch.core.faults import FaultModel
    from repro_torch.models import regression as treg
    from repro_torch.walk_sgd import fleet as tfleet

    engine, _, _ = interop.from_reference_state(
        indptr=inp["indptr"], indices=inp["indices"], degrees=inp["degrees"],
        edge_cdf=inp["edge_cdf"], max_degree=int(inp["max_degree"]),
        cdf_width=int(inp["max_degree"]), p_d=float(inp["p_d"]),
        r=int(inp["r"]), device=dev)
    feats, targs, weights, sched = (torch.as_tensor(inp[k], device=dev) for k in
                                    ("features", "targets", "weights", "sched"))
    w = P15_TRAIN["walkers"]
    out, info = {}, {}
    for name, walks, steps, faults in (
            ("plain", w, P15_RANK_STEPS, None),
            ("faulted", w, P15_RANK_STEPS, FaultModel(**P15_FAULTS)),
            ("odd", w + 1, P15_ODD_STEPS, None)):
        fleet = tfleet.WalkFleet.create(engine, walks, seed=0,
                                        avg_every=P15_TRAIN["avg_every"])
        counts_zero(wt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with ScanLog() as sl:
            res = tfleet.run_fleet(
                torch.zeros(walks, feats.shape[1], device=dev), feats, targs,
                weights, fleet, steps, float(inp["gamma"]), sched[:steps],
                True, treg.linear_grad, faults=faults, mesh=mesh,
                generator=torch.Generator(device=dev).manual_seed(15))
            torch.cuda.synchronize()
        stats = sl.stats[0]
        info[name] = {"s": time.perf_counter() - t0, "steps": steps,
                      "launches": counts_read(wt)["walk_transition_ragged"],
                      "captured": stats.captured,
                      "uncaptured_by": stats.uncaptured_by,
                      "sharded": mesh is not None and tfleet.shard_fleet(
                          fleet, mesh).mesh is not None}
        for k, v in zip(("x_final", "mse", "avg_mse", "nodes", "hops"), res):
            out[f"{name}/{k}"] = v.cpu().numpy()
        out[f"{name}/final_nodes"] = res[5]["nodes"].cpu().numpy()
        if faults is not None:
            fs = res[5]["fault_state"]
            for k, v in (("live", fs.live), ("blocked_state", fs.blocked),
                         ("rescued", res[5]["rescued"]),
                         ("blocked", res[5]["blocked"])):
                out[f"{name}/{k}"] = v.cpu().numpy()
    return out, info


def p15_llm(dev, mesh, wt) -> tuple:
    """(e): the LLM fleet step, P15_LLM's reduced archs in float32 (seed 0),
    W walkers on a ring(8) with the online estimator, AdamW, averaging
    every ``avg_every`` steps, the same batches; under ``mesh`` the ranks
    split the walkers.  Returns each arch's walks per step and final
    parameters (the whole fleet's, numpy), seconds and sparse launches."""
    from repro_torch import optim as topt
    from repro_torch.configs import get_arch, reduced
    from repro_torch.core.graphs import ring
    from repro_torch.core.transition import MHLJParams
    from repro_torch.models.base import param_tree, stack_leaf
    from repro_torch.models.factory import build_model
    from repro_torch.walk_sgd import fleet as tfleet
    from repro_torch.walk_sgd import llm_trainer as tllm

    w, steps = P15_LLM["walkers"], P15_LLM["steps"]
    out, info = {}, {}
    for arch in P15_LLM["archs"]:
        cfg = reduced(get_arch(arch))
        model = build_model(cfg, torch.float32, device=dev,
                            generator=torch.Generator(dev).manual_seed(0))
        tree = param_tree(model)
        walk = tllm.WalkContext.from_graph(ring(8), MHLJParams(0.3, 0.5, 3),
                                           online_lipschitz=True, device=dev)
        opt = topt.adamw(P15_LLM["lr"])
        pw, ow = tfleet.stack_params(tree, w), tfleet.stack_params(
            opt.init(tree), w)
        if mesh is not None:
            pw, ow = (tfleet.shard_walker_batch(x, w, mesh) for x in (pw, ow))
        ws = tfleet.init_fleet_walk_state(8, w, seed=2, online=True,
                                          device=dev, mesh=mesh)
        step = tfleet.make_fleet_step(model, opt, walk, P15_LLM["avg_every"],
                                      mesh=mesh)
        rng = np.random.default_rng(5)
        counts_zero(wt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes = []
        for t in range(steps):
            batch = {k: torch.as_tensor(rng.integers(
                0, cfg.vocab_size, (w, 2, 32)).astype(np.int32), device=dev)
                for k in ("tokens", "labels")}
            pw, ow, ws, _ = step(pw, ow, ws, batch, t)
            nodes.append(mesh_gather(ws["node"], mesh))
        torch.cuda.synchronize()
        info[arch] = {"s": time.perf_counter() - t0,
                      "launches": counts_read(wt)["walk_transition_sparse"]}
        out[f"{arch}/nodes"] = torch.stack(nodes).cpu().numpy()
        for path, leaf in pw.items():
            x = stack_leaf(leaf)
            if isinstance(leaf, tuple):  # (L, W, ...) -> (W, L, ...)
                x = x.movedim(1, 0)
            out[f"{arch}/params/{path}"] = mesh_gather(x, mesh).cpu().numpy()
        del model, tree, pw, ow
    return out, info


def rank15(rank: int, world: int, workdir: str, with_llm: bool) -> None:
    """One rank of phase 15 (c) and (e): a gloo walker mesh of ``world``
    processes, all on the one card.  Rank 0 writes the whole fleet's
    outputs; every rank writes its own counts, times and collective cost."""
    import torch.distributed as dist

    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.launch.mesh import make_walker_mesh

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    torch.cuda.set_device(0)
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rv{world}",
                            world_size=world, rank=rank)
    try:
        mesh = make_walker_mesh()
        with np.load(os.path.join(workdir, "inputs.npz")) as z:
            inp = dict(z)
        out, info = p15_runs(inp, dev, mesh, wt)
        if with_llm:
            llm, info["llm"] = p15_llm(dev, mesh, wt)
            out.update({f"llm/{k}": v for k, v in llm.items()})
        info["collective_ms"] = collective_ms(mesh, dev, inp["features"].shape[1])
        if rank == 0:
            np.savez(os.path.join(workdir, f"out{world}.npz"), **out)
        with open(os.path.join(workdir, f"info{world}-{rank}.json"), "w") as fh:
            json.dump(info, fh)
    finally:
        dist.destroy_process_group()


def nccl_probe(rank: int, world: int, workdir: str) -> None:
    """Two NCCL ranks on the one card: one all-reduce; writes what NCCL said."""
    import torch.distributed as dist

    torch.cuda.set_device(0)
    try:
        dist.init_process_group(
            "nccl", init_method=f"file://{workdir}/rv-nccl", world_size=world,
            rank=rank, device_id=torch.device("cuda", 0))
        x = torch.ones(1, device="cuda")
        dist.all_reduce(x)
        torch.cuda.synchronize()
        msg = f"no error: the all-reduce gave {x.item()}"
    except Exception as err:  # noqa: BLE001  (the probe reports any refusal)
        msg = f"{type(err).__name__}: {err}"
    with open(os.path.join(workdir, f"nccl{rank}.txt"), "w") as fh:
        fh.write(msg)
    if dist.is_initialized():
        dist.destroy_process_group()


def close_floats(got: dict, want: dict, prefix: str) -> bool:
    """The reference's sharded-fleet tolerances (``tests/test_fleet.py``):
    ``mse``/``avg_mse`` at rtol 1e-5, ``x_final`` at rtol 1e-4 / atol 1e-6."""
    return (np.allclose(got[f"{prefix}/mse"], want[f"{prefix}/mse"], rtol=1e-5,
                        atol=0)
            and np.allclose(got[f"{prefix}/avg_mse"], want[f"{prefix}/avg_mse"],
                            rtol=1e-5, atol=0)
            and np.allclose(got[f"{prefix}/x_final"], want[f"{prefix}/x_final"],
                            rtol=1e-4, atol=1e-6))


def same_walks(got: dict, want: dict, prefix: str, keys=("nodes", "hops",
                                                         "final_nodes")) -> bool:
    return all(np.array_equal(got[f"{prefix}/{k}"], want[f"{prefix}/{k}"])
               for k in keys)


def phase15_mesh_trainer(dev, wt, ttrain, mesh, params, gates) -> dict:
    """(a) phase 3's trainer through ``run_rw_sgd_multi(mesh=)`` on the
    one-rank NCCL mesh, captured with its collectives, against the same loop
    with ``mesh=None`` from the same generator state: every field bit for
    bit; the walks' digest is phase 3's; both loops' replayed ms/step; a
    profiled window's NCCL kernels.  Returns the inputs (c) replays."""
    from repro_torch.core.graphs import barabasi_albert
    from repro_torch.data import make_heterogeneous_regression

    g = barabasi_albert(*P15_GRAPH, seed=0, layout="ragged")
    data = make_heterogeneous_regression(g.n, dim=6, sigma_high_sq=100.0,
                                         p_high=0.03, seed=7, x_star_scale=3.0)
    gamma = float(0.3 / data.lipschitz.mean())
    w, steps = P15_TRAIN["walkers"], P15_TRAIN["steps"]
    counts_zero(wt)
    res, seen = timed_training(ttrain, "mhlj", g, data, gamma, steps, w,
                               mhlj_params=params,
                               avg_every=P15_TRAIN["avg_every"], seed=0,
                               device=dev, mesh=mesh)
    launches = counts_read(wt)
    stats = seen["scan"]
    args = list(seen["args"])
    kw = {k: v for k, v in seen["kwargs"].items() if k != "mesh"}
    gen = torch.Generator(device=dev)
    gen.set_state(seen["gen_state"])
    counts_zero(wt)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with ScanLog() as sl:
        plain = ttrain.run_fleet(*args, **dict(kw, generator=gen))
        torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    plain_launches = counts_read(wt)
    got = {"x_final": res.x_final, "mse": res.mse, "avg_mse": res.avg_mse,
           "update_nodes": res.update_nodes, "transitions": res.transitions}
    equal = all(np.array_equal(got[k], t.cpu().numpy()) for k, t in zip(
        ("x_final", "mse", "avg_mse", "update_nodes", "transitions"), plain))
    mesh_loop = scan_summary(stats, seen["loop_s"])
    plain_loop = scan_summary(sl.stats[0], plain_s)

    def mesh_window():
        g2 = torch.Generator(device=dev)
        g2.set_state(seen["gen_state"])
        ttrain.run_fleet(*args[:5], PROFILE_STEPS, *args[6:7],
                         args[7][:PROFILE_STEPS], *args[8:],
                         **dict(seen["kwargs"], generator=g2))

    prof = profile_window(mesh_window, "nccl", after="scan.capture")
    nccl_events = {k: v for k, v in prof.get("device_launches_by_name",
                                             {}).items() if "nccl" in k}
    trainer_digest = digest(res.update_nodes, res.transitions)
    nccl_ms = collective_ms(mesh, dev, data.dim)
    # the fleet's mean is sum / W on both paths; Tensor.mean, for the record
    gm = torch.Generator(device=dev).manual_seed(0)
    mean_bits = {}
    for walks in (2, 3, 7, 2048, 2049):
        x = torch.randn(walks, data.dim, generator=gm, device=dev) * 10
        mean_bits[walks] = torch.equal(x.mean(0), x.sum(0) / walks)
    log(f"  (a) trainer mhlj BA{P15_GRAPH} W={w} T={steps} on the one-rank NCCL "
        f"mesh: {launches['walk_transition_ragged']} ragged launches, "
        f"captured {stats.captured}, replayed {mesh_loop['replayed_ms_per_step']:.5f} "
        f"ms/step (K={stats.chunk} x {stats.replays} + {stats.tail}); "
        f"mesh=None {plain_launches['walk_transition_ragged']} launches, "
        f"captured {sl.stats[0].captured}, replayed "
        f"{plain_loop['replayed_ms_per_step']:.5f} ms/step; every field bit "
        f"for bit: {equal}; walks' digest {trainer_digest}")
    log(f"  (a) profiled {PROFILE_STEPS}-step mesh loop after its capture: "
        f"idle share {prof['idle_share']}, NCCL device events {nccl_events} "
        f"(the gathers at the end: a one-rank all-reduce in place launches "
        f"nothing); one eager NCCL all-reduce of ({data.dim},) float32 "
        f"{nccl_ms:.5f} ms; Tensor.mean == sum / W on the card at (W, "
        f"{data.dim}): {mean_bits}")
    gate(gates, "(a) mesh trainer == mesh=None, every field bit for bit", equal)
    gate(gates, "(a) mesh loop captured with its collectives", stats.captured)
    gate(gates, "(a) 500 ragged launches each",
         launches["walk_transition_ragged"] == steps
         == plain_launches["walk_transition_ragged"])
    gate(gates, "(a) the walks are phase 3's",
         trainer_digest == WALK_DIGESTS["trainer"])
    e = seen["fleet"].engine
    inputs = {"indptr": e.indptr.cpu().numpy(), "indices": e.indices.cpu().numpy(),
              "degrees": e.degrees.cpu().numpy(),
              "edge_cdf": e.edge_cdf.cpu().numpy(), "max_degree": e.max_degree,
              "p_d": e.p_d, "r": e.r, "gamma": args[6],
              "features": args[1].cpu().numpy(), "targets": args[2].cpu().numpy(),
              "weights": args[3].cpu().numpy(), "sched": args[7].cpu().numpy()}
    return {"launches": launches, "plain_launches": plain_launches,
            "loop": mesh_loop, "plain_loop": plain_loop, "equal": equal,
            "captured": stats.captured, "profile": prof,
            "nccl_events": nccl_events, "mean_equals_sum_over_w": mean_bits,
            "nccl_allreduce_ms": nccl_ms, "walks_digest": trainer_digest,
            "inputs": inputs}


def phase15_sweep(dev, wt, ttrain, mesh, params, gates) -> dict:
    """(b) the fleet section of ``benchmarks/large_graph_walk.py`` at
    ``full`` under the mesh: the ragged engine on BA(100k,3) (lipschitz
    seeded 11) at W in P15_SWEEP_WALKS for P15_SWEEP_STEPS steps, aggregate
    walk-steps/s and the ``sharded`` flag (the walks equal the unsharded
    engine's); then ring(128)'s convergence against W, averaging every 50:
    the final ``avg_mse`` over the least-squares floor and hops/update."""
    from repro_torch.core.engine import WalkEngine
    from repro_torch.core.graphs import barabasi_albert, ring
    from repro_torch.data import make_heterogeneous_regression
    from repro_torch.walk_sgd import fleet as tfleet

    g = barabasi_albert(*P15_GRAPH, seed=0, layout="csr")
    rng = np.random.default_rng(11)
    lips = np.exp(rng.normal(0.0, 1.0, g.n)).astype(np.float32)
    engine = WalkEngine.from_graph(g, params, lipschitz=lips, layout="ragged",
                                   device=dev)
    rows = {}
    for w in P15_SWEEP_WALKS:
        v0s = torch.as_tensor(rng.integers(0, g.n, w).astype(np.int32),
                              device=dev)
        fleet = tfleet.shard_fleet(
            tfleet.WalkFleet(engine=engine, nodes=v0s, num_walks=w), mesh)
        e = fleet.engine
        e.run(fleet.nodes, P15_SWEEP_STEPS,
              generator=torch.Generator(device=dev).manual_seed(3))  # warm
        counts_zero(wt)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        nodes, _ = e.run(fleet.nodes, P15_SWEEP_STEPS,
                         generator=torch.Generator(device=dev).manual_seed(4))
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        launches = counts_read(wt)["walk_transition_ragged"]
        unsharded, _ = engine.run(v0s, P15_SWEEP_STEPS,
                                  generator=torch.Generator(device=dev).manual_seed(4))
        same = torch.equal(fleet.all_nodes(), v0s) and torch.equal(
            mesh_gather(nodes, fleet.mesh), unsharded)
        rows[w] = {"num_walkers": w, "sharded": fleet.mesh is not None,
                   "aggregate_walk_steps_per_sec": w * P15_SWEEP_STEPS / dt,
                   "launches": launches, "equal_unsharded": same}
        log(f"  (b) fleet row W={w}: sharded {rows[w]['sharded']}, "
            f"{rows[w]['aggregate_walk_steps_per_sec']:.4e} aggregate "
            f"walk-steps/s ({dt * 1e3 / P15_SWEEP_STEPS:.5f} ms/step), "
            f"{launches} ragged launches, walks == unsharded {same}")
        gate(gates, f"(b) fleet row W={w} walks == unsharded, "
             f"{P15_SWEEP_STEPS} launches", same and launches == P15_SWEEP_STEPS)
    n = 128
    data = make_heterogeneous_regression(n, dim=6, sigma_high_sq=100.0,
                                         p_high=0.03, seed=7, x_star_scale=3.0)
    gamma = float(0.3 / data.lipschitz.mean())
    floor = float(data.mse(data.optimum()))
    conv = {}
    for w in P15_CONV["walkers"]:
        counts_zero(wt)
        t0 = time.perf_counter()
        res = ttrain.run_rw_sgd_multi(
            "mhlj", ring(n), data, gamma, P15_CONV["steps"], w,
            mhlj_params=params, seed=0, avg_every=P15_CONV["avg_every"],
            mesh=mesh, device=dev)
        conv[w] = {"num_walkers": w, "avg_every": P15_CONV["avg_every"],
                   "final_avg_mse": float(res.avg_mse[-1]),
                   "excess_over_floor": float(res.avg_mse[-1]) - floor,
                   "transitions_per_update": res.transitions_per_update,
                   "s": time.perf_counter() - t0,
                   "launches": counts_read(wt)["walk_transition_sparse"]}
        log(f"  (b) convergence ring(128) W={w} T={P15_CONV['steps']}: excess "
            f"{conv[w]['excess_over_floor']:.6g} over floor {floor:.6g}, "
            f"hops/update {conv[w]['transitions_per_update']:.4f} "
            f"({conv[w]['s']:.2f} s, {conv[w]['launches']} sparse launches)")
        gate(gates, f"(b) convergence W={w} one sparse launch a step",
             conv[w]["launches"] == P15_CONV["steps"])
    return {"rows": rows, "convergence": conv, "ls_floor_mse": floor}


def phase15_ranks(dev, wt, inputs: dict, gates) -> dict:
    """(c) P15_RANKS processes on the one card over gloo (CUDA tensors
    staged through the host): (a)'s trainer loop for P15_RANK_STEPS steps,
    plain and under Markov faults, and W + 1 walkers (replicated), each
    against the same run unsharded (captured) in this process: walks and
    the fault state bit for bit, floats at the reference's tolerances,
    every field of the replicated fleet bit for bit; each rank's ragged
    launches; one gloo all-reduce's cost.  First, NCCL with two ranks on
    the card, once.  (e) rides the P = 2 group (:func:`phase15_llm_check`)."""
    import tempfile

    workdir = tempfile.mkdtemp(prefix="phase15-", dir=os.path.join(ROOT, "build"))
    np.savez(os.path.join(workdir, "inputs.npz"), **inputs)
    t0 = time.perf_counter()
    finished = spawn_ranks(nccl_probe, 2, (workdir,), P15_PROBE_S, fail=False)
    said = []
    for rank in range(2):
        path = os.path.join(workdir, f"nccl{rank}.txt")
        said.append(open(path).read() if os.path.exists(path) else "nothing")
    probe = {"finished": finished, "said": said, "s": time.perf_counter() - t0}
    log(f"  (c) NCCL, two ranks on one card ({probe['s']:.2f} s, "
        f"{'exited' if finished else f'killed after {P15_PROBE_S:.0f} s'}): "
        f"rank 0: {said[0][:400]}")
    ref, ref_info = p15_runs(inputs, dev, None, wt)
    for name, i in ref_info.items():
        log(f"  (c) unsharded {name} on the card: {i['s']:.2f} s, "
            f"{i['launches']} ragged launches, captured {i['captured']}")
    llm_ref, llm_ref_info = p15_llm(dev, None, wt)
    out = {"probe": probe, "reference": ref_info, "llm_reference": llm_ref_info}
    for world in P15_RANKS:
        t0 = time.perf_counter()
        spawn_ranks(rank15, world, (workdir, world == 2), P15_JOIN_S)
        wall = time.perf_counter() - t0
        with np.load(os.path.join(workdir, f"out{world}.npz")) as z:
            got = dict(z)
        infos = []
        for rank in range(world):
            with open(os.path.join(workdir, f"info{world}-{rank}.json")) as fh:
                infos.append(json.load(fh))
        row = {"wall_s": wall, "ranks": infos}
        for name in ("plain", "faulted"):
            walks = same_walks(got, ref, name)
            floats = close_floats(got, ref, name)
            if name == "faulted":
                walks = walks and all(np.array_equal(
                    got[f"faulted/{k}"], ref[f"faulted/{k}"]) for k in
                    ("live", "blocked_state", "rescued", "blocked"))
            gate(gates, f"(c) P={world} {name}: walks bit for bit", walks)
            gate(gates, f"(c) P={world} {name}: floats within the all-reduce "
                 "tolerances", floats)
        odd = all(np.array_equal(got[k], ref[k]) for k in ref
                  if k.startswith("odd/"))
        gate(gates, f"(c) P={world} W={P15_TRAIN['walkers'] + 1}: replicated, "
             "every field bit for bit", odd and not any(
                 i["odd"]["sharded"] for i in infos))
        per_rank = [{k: i[k]["launches"] for k in ("plain", "faulted", "odd")}
                    for i in infos]
        gate(gates, f"(c) P={world} every rank launched the ragged kernel "
             "each step", all(c == {"plain": P15_RANK_STEPS,
                                   "faulted": P15_RANK_STEPS,
                                   "odd": P15_ODD_STEPS} for c in per_rank))
        gate(gates, f"(c) P={world} gloo loops uncaptured, with the reason",
             all(not i[k]["captured"] and i[k]["uncaptured_by"]
                 for i in infos for k in ("plain", "faulted")))
        ms = [i["plain"]["s"] * 1e3 / P15_RANK_STEPS for i in infos]
        coll = [i["collective_ms"] for i in infos]
        log(f"  (c) P={world} gloo ranks on the card ({wall:.2f} s with the "
            f"spawn): ragged launches per rank {per_rank}; plain loop "
            f"{max(ms):.4f} ms/step (slowest rank, uncaptured, host-bound) "
            f"against {ref_info['plain']['s'] * 1e3 / P15_RANK_STEPS:.4f} "
            f"unsharded captured; one gloo all-reduce of "
            f"({inputs['features'].shape[1]},) float32 {max(coll):.4f} ms")
        if world == 2:
            row["llm"] = phase15_llm_check(got, llm_ref, infos, gates)
        out[f"P{world}"] = row
    return out


def phase15_llm_check(got: dict, ref: dict, infos: list, gates) -> dict:
    """(e) the P = 2 group's LLM fleet steps against the unsharded steps on
    the card: walks equal, parameters within ``test_torch_llm_train``'s
    fleet bound (rtol 1e-4 / atol 1e-3·lr, at most 1e-4 of the entries
    beyond, each within 2·lr a step)."""
    lr, steps = P15_LLM["lr"], P15_LLM["steps"]
    out = {}
    for arch in P15_LLM["archs"]:
        nodes = np.array_equal(got[f"llm/{arch}/nodes"], ref[f"{arch}/nodes"])
        beyond = total = 0
        worst = 0.0
        for k, x in ref.items():
            if not k.startswith(f"{arch}/params/"):
                continue
            diff = np.abs(got[f"llm/{k}"] - x)
            beyond += int((diff > 1e-3 * lr + 1e-4 * np.abs(x)).sum())
            total += x.size
            worst = max(worst, float(diff.max()))
        launches = [i["llm"][arch]["launches"] for i in infos]
        out[arch] = {"nodes_equal": nodes, "beyond": beyond, "total": total,
                     "max_abs_diff": worst, "launches_per_rank": launches,
                     "s": max(i["llm"][arch]["s"] for i in infos)}
        log(f"  (e) {arch} fleet step, 2 gloo ranks, W={P15_LLM['walkers']}, "
            f"{steps} steps: walks equal {nodes}; {beyond} of {total} "
            f"parameters beyond rtol 1e-4 / atol 1e-3·lr (max |diff| "
            f"{worst:.3g}); sparse launches per rank {launches}; "
            f"{out[arch]['s']:.2f} s")
        gate(gates, f"(e) {arch}: walks equal, parameters within the bound, "
             "one sparse launch a step per rank",
             nodes and beyond <= 1e-4 * total and worst <= 2 * lr * steps
             and launches == [steps, steps])
    return out


P15_MULTI_WALK_T = 10_000  # (d)'s T (the full tier's 20,000 until phase 16)


def phase15_multi_walk(dev, wt, mesh, gates) -> dict:
    """(d) ``repro_torch.paper.multi_walk`` at the full tier's repetitions
    and walkers, T = ``P15_MULTI_WALK_T``, through the mesh."""
    from repro_torch.paper import multi_walk

    counts_zero(wt)
    t0 = time.perf_counter()
    res = multi_walk.run(device=dev, mesh=mesh, num_steps=P15_MULTI_WALK_T)
    dt = time.perf_counter() - t0
    launches = counts_read(wt)["walk_transition_sparse"]
    d = res["derived"]
    runs = len(multi_walk.WALKERS) * res["reps"]
    log(f"  (d) multi_walk ({runs} runs of T={res['T']}, mesh devices "
        f"{res['mesh_devices']}): variance_reduction_w8 "
        f"{d['variance_reduction_w8']:.6g} (excess w1 {d['excess_w1']:.6g}, "
        f"w8 {d['excess_w8']:.6g}), aggregate walk-steps/s at W=8 "
        f"{d['aggregate_walk_steps_per_sec_w8']:.4e}; {launches} sparse "
        f"launches; {dt:.2f} s")
    gate(gates, "(d) excess_w8 < excess_w1", d["excess_w8"] < d["excess_w1"])
    gate(gates, "(d) one sparse launch a step", launches == runs * res["T"])
    return {**res, "s": dt, "launches": launches}


def phase_fleet_mesh(dev, smi, ttrain, params) -> dict:
    """Phase 15: the multi-device walker fleet, on the one card: a one-rank
    NCCL mesh for (a), (b) and (d), gloo ranks for (c) and (e)."""
    import torch.distributed as dist

    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.launch.mesh import make_walker_mesh

    torch.cuda.empty_cache()
    log(f"phase 15 (the walker fleet across ranks): {smi}; aim "
        f"{PHASE15_AIM_S:.0f} s")
    dist.init_process_group(
        "nccl", init_method=f"tcp://localhost:{free_port()}", world_size=1,
        rank=0, device_id=torch.device("cuda", torch.cuda.current_device()))
    gates: dict = {}
    out: dict = {}
    marks = [time.perf_counter()]
    try:
        mesh = make_walker_mesh()
        out["mesh_trainer"] = phase15_mesh_trainer(dev, wt, ttrain, mesh, params,
                                                   gates)
        marks.append(time.perf_counter())
        out["sweep"] = phase15_sweep(dev, wt, ttrain, mesh, params, gates)
        marks.append(time.perf_counter())
        out["ranks"] = phase15_ranks(dev, wt, out["mesh_trainer"].pop("inputs"),
                                     gates)
        marks.append(time.perf_counter())
        out["multi_walk"] = phase15_multi_walk(dev, wt, mesh, gates)
        marks.append(time.perf_counter())
    finally:
        dist.destroy_process_group()
    out["part_s"] = dict(zip(("mesh_trainer", "sweep", "ranks", "multi_walk"),
                             np.diff(marks).tolist()))
    log("  phase 15 parts: " + ", ".join(
        f"{k} {v:.2f} s" for k, v in out["part_s"].items()))
    out["gates"] = gates
    failed = [k for k, ok in gates.items() if not ok]
    if failed:
        raise AssertionError(f"phase 15: {failed}")
    return out


T_START = time.perf_counter()


# -- phase 16: the dry-run and roofline tooling ------------------------------

PHASE16_AIM_S = 90.0  # phase 16's aim; (b) runs in a subprocess from the start
P16_ARCHS = ("minitron-8b", "mamba2-370m")
P16_SEQ = 4096
# the card's peak allocation over its baseline, as a fraction of the plan's
# argument + temp bytes (PERF.md's prediction, written before the run)
P16_PEAK_BOUNDS = (0.95, 1.20)
# each example's arguments on the card, and the line of its output printed
P16_EXAMPLES = {
    "quickstart": ((), "Remark 1:"),
    "entrapment_demo": (("--small",), "occupancy of top node"),
    "annealing_error_gap": (("--small",), "annealed 0.3->0"),
    "llm_decentralized": (("--small",), "mhlj     loss"),
    "serve_demo": (("--small",), "mhlj "),
}
P16_DRYRUN = None  # the (b) subprocess
# (b)'s reduced plans: one model of each family (tests/test_torch_dryrun_
# families.py's), each x train, prefill and decode on a fake (2, 2) mesh
P16_FAMILIES = {"dense": "minitron-8b", "moe": "olmoe-1b-7b",
                "ssm": "mamba2-370m", "hybrid": "jamba-1.5-large-398b",
                "audio": "whisper-tiny", "vlm": "paligemma-3b"}
P16_KINDS = ("train", "prefill", "decode")


def start_phase16_dryrun() -> None:
    """Start phase 16's plans in a CPU process (they need no card, and run
    beside phases 1-15): (a)'s (1, 1) plan of each of ``P16_ARCHS``,
    (b)'s plan of each x the four input shapes on the 16x16 mesh and (b)'s
    reduced plans of the six families, under ``build/phase16-*``."""
    import atexit

    global P16_DRYRUN
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    for name in ("phase16-dryrun.jsonl", "phase16-plans.json",
                 "phase16-reduced.json"):
        if os.path.exists(os.path.join(ROOT, "build", name)):
            os.remove(os.path.join(ROOT, "build", name))
    # one thread at the lowest priority: the host's cores are the card
    # phases' first
    env = {**os.environ, "CUDA_VISIBLE_DEVICES": "", "OMP_NUM_THREADS": "1",
           "PYTHONPATH": os.path.join(ROOT, "src")}
    log_fh = open(os.path.join(ROOT, "build", "phase16-dryrun.log"), "w")
    P16_DRYRUN = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--phase16-plans"],
        cwd=ROOT, env=env, stdout=log_fh, stderr=subprocess.STDOUT,
        preexec_fn=lambda: os.nice(19))
    atexit.register(lambda: P16_DRYRUN.poll() is None and P16_DRYRUN.kill())


def phase16_plans() -> int:
    """The body of the CPU process :func:`start_phase16_dryrun` starts."""
    from repro_torch.configs import ShapeConfig
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_smoke_mesh

    shape = ShapeConfig(f"prefill_{P16_SEQ}", P16_SEQ, 1, "prefill")
    plans = {}
    for arch in P16_ARCHS:
        t0 = time.perf_counter()
        _, cost, info = dryrun.lower_case(arch, shape, False,
                                          extra={"use_kernels": True},
                                          mesh=make_smoke_mesh())
        plans[arch] = {"s": time.perf_counter() - t0, "flops": cost.flops,
                       "bytes": cost.bytes, "memory": info["memory"],
                       "collectives": info["collectives"]["num_ops"]}
        print(f"plan {arch} 1x{P16_SEQ} on (1, 1): {plans[arch]}", flush=True)
    with open(os.path.join(ROOT, "build", "phase16-plans.json"), "w") as fh:
        json.dump(plans, fh)
    rc = dryrun.main(["--arch", ",".join(P16_ARCHS), "--shape", "all",
                      "--mesh", "single", "--out",
                      os.path.join(ROOT, "build", "phase16-dryrun.jsonl")])
    reduced_plans()
    return rc


def reduced_plans() -> None:
    """(b)'s reduced plans: each family's reduced model x ``P16_KINDS`` on
    a fake (2, 2) mesh, as tests/test_torch_dryrun_families.py traces them
    (64 tokens, batch 4), into ``build/phase16-reduced.json``: each case's
    status, FLOPs, bytes, collectives and seconds, or its error."""
    from repro_torch.configs import ShapeConfig, get_arch, reduced
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import AbstractMesh

    out = {}
    for family, arch in sorted(P16_FAMILIES.items()):
        cfg = reduced(get_arch(arch))
        for kind in P16_KINDS:
            t0 = time.perf_counter()
            try:
                _, cost, info = dryrun.lower_case(
                    cfg, ShapeConfig(f"small_{kind}", 64, 4, kind), False,
                    mesh=AbstractMesh((2, 2), ("data", "model")))
                coll = info["collectives"]
                good = (cost.flops > 0 and cost.bytes > 0 and coll["num_ops"] > 0
                        and cost.coll_bytes == coll["total_bytes"] > 0
                        and not torch.distributed.is_initialized())
                rec = {"status": "ok" if good else "wrong", "flops": cost.flops,
                       "bytes": cost.bytes, "collectives": coll["num_ops"]}
            except Exception as exc:  # recorded, and phase 16 fails on it
                rec = {"status": "error", "error": f"{type(exc).__name__}: {exc}"}
            rec["s"] = time.perf_counter() - t0
            out[f"{family} {arch} {kind}"] = rec
            print(f"reduced plan {family} {arch} {kind} on (2, 2): {rec}",
                  flush=True)
    with open(os.path.join(ROOT, "build", "phase16-reduced.json"), "w") as fh:
        json.dump(out, fh)


def plan_vs_card(arch: str, plan: dict, dev) -> dict:
    """Phase 16 (a) for one architecture: ``plan`` (the (1, 1) plan from
    :func:`phase16_plans`) against the same prefill on the card (seed-0
    weights), on the kernel path and the plain path, each counted by
    ``op_cost``."""
    import dataclasses

    from repro_torch.configs import get_arch
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.kernels.ssd import ops as ssd_ops
    from repro_torch.launch import dryrun
    from repro_torch.models.factory import build_model
    from repro_torch.utils.op_cost import count_ops

    mem = plan["memory"]
    plan_peak = mem["argument_size_in_bytes"] + mem["temp_size_in_bytes"]
    if plan["collectives"]:
        raise AssertionError(f"{arch}: the (1, 1) plan issued "
                             f"{plan['collectives']} collectives")
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    cfg = dataclasses.replace(get_arch(arch), use_kernels=True)
    model = build_model(cfg, torch.bfloat16, device=dev)
    gen = torch.Generator(device=dev).manual_seed(16)
    tokens = torch.randint(0, cfg.vocab_size, (1, P16_SEQ), generator=gen,
                           device=dev, dtype=torch.int32)
    batch = {"tokens": tokens, "labels": tokens.clone()}
    measured_args = sum(p.numel() * p.element_size() for p in model.parameters())
    measured_args += sum(t.numel() * t.element_size() for t in batch.values())
    if measured_args != mem["argument_size_in_bytes"]:
        raise AssertionError(
            f"{arch}: the plan's argument bytes {mem['argument_size_in_bytes']} "
            f"are not the card's {measured_args}")
    prefill = dryrun.make_prefill_step(model)

    def step(b):
        with torch.no_grad():  # the plan's weights record no autograd
            return prefill(b)

    step(batch)  # warm: cuBLAS and the kernels' libraries
    torch.cuda.synchronize()
    fa_ops.mha.launches, ssd_ops.ssd_scan.launches = 0, 0
    torch.cuda.reset_peak_memory_stats()
    with count_ops() as kernel_count:
        logits_k = step(batch)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated() - base
    launches = {"flash_attention": fa_ops.mha.launches,
                "ssd_scan": ssd_ops.ssd_scan.launches}
    model.cfg = dataclasses.replace(cfg, use_kernels=False)
    with count_ops() as plain_count:
        logits_p = step(batch)
    model.cfg = cfg
    k, p = kernel_count.cost, plain_count.cost
    if (k.flops, k.bytes) != (p.flops, p.bytes):
        raise AssertionError(f"{arch}: the kernel path counts {k.flops:.6e} "
                             f"FLOPs / {k.bytes:.6e} B, the plain path "
                             f"{p.flops:.6e} / {p.bytes:.6e}")
    if not (torch.isfinite(logits_k).all() and logits_k.shape == (1, cfg.vocab_size)):
        raise AssertionError(f"{arch}: the prefill's logits are not finite "
                             f"(1, {cfg.vocab_size})")
    rel = float((logits_k - logits_p).norm() / logits_p.norm())
    ratio = peak / plan_peak
    lo, hi = P16_PEAK_BOUNDS
    if not lo <= ratio <= hi:
        raise AssertionError(f"{arch}: the card's peak {peak} B is {ratio:.4f}x "
                             f"the plan's {plan_peak} B, outside {P16_PEAK_BOUNDS}")
    times = []
    for _ in range(5):
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        step(batch)
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    ms = sorted(times)[len(times) // 2]
    bound_ms, bound_by = bound(k.bytes, k.flops, BF16_OPS_PER_S)
    log(f"  {arch} prefill 1x{P16_SEQ} bf16 kernels: plan ({plan['s']:.1f} s on "
        f"the host) args {mem['argument_size_in_bytes']} B == card "
        f"{measured_args} B; plan peak {plan_peak} B (temp "
        f"{mem['temp_size_in_bytes']} B), card peak over baseline {peak} B "
        f"({ratio:.4f}x the plan, gate {P16_PEAK_BOUNDS}); counted kernel path "
        f"{k.flops:.6e} FLOPs {k.bytes:.6e} B == plain path; plan "
        f"{plan['flops']:.6e} FLOPs {plan['bytes']:.6e} B; logits kernel vs plain "
        f"relative error {rel:.3e}; launches {launches}; {ms:.3f} ms a prefill "
        f"(CUDA events, median of 5, host gaps included) against its counted "
        f"bound {bound_ms:.3f} ms by {bound_by}: {bound_ms / ms:.1%}")
    del model, batch, logits_k, logits_p
    torch.cuda.empty_cache()
    return {"plan_s": plan["s"], "plan_flops": plan["flops"],
            "plan_bytes": plan["bytes"],
            "argument_bytes": measured_args, "plan_temp_bytes": mem["temp_size_in_bytes"],
            "plan_peak_bytes": plan_peak, "card_peak_bytes": peak,
            "peak_ratio": ratio, "flops": k.flops, "bytes": k.bytes,
            "logits_rel_err": rel, "launches": launches, "ms": ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "bound_share": bound_ms / ms}


def run_example(name: str, argv, device: str = "cuda") -> tuple:
    """``examples/torch/<name>.py``'s ``main`` on ``device``, its standard
    output captured: ``(result, output)``."""
    import contextlib
    import importlib.util
    import io

    path = os.path.join(ROOT, "examples", "torch", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"example_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = module.main(["--device", device, *argv])
    return result, buf.getvalue()


def phase_tooling(dev, smi) -> dict:
    """Phase 16: (a) the plan against the card, (b) the 16x16 plans, (c)
    the examples.  Returns each part's numbers and each path's launches."""
    from repro_torch.kernels.walk_transition import kernel as wt
    from repro_torch.launch.roofline import analyze_record

    out = {"plans": {}, "examples": {}}
    t0 = time.perf_counter()
    rc = P16_DRYRUN.wait(timeout=600)  # started before phase 1
    waited = time.perf_counter() - t0
    log(f"  the plans' CPU process: waited {waited:.1f} s for it here, exit {rc}")
    with open(os.path.join(ROOT, "build", "phase16-plans.json")) as fh:
        plans = json.load(fh)
    # (a) each (1, 1) plan against the card
    for arch in P16_ARCHS:
        out["plans"][arch] = plan_vs_card(arch, plans[arch], dev)
    # (b) the 16x16 plans
    with open(os.path.join(ROOT, "build", "phase16-dryrun.jsonl")) as fh:
        recs = [json.loads(line) for line in fh]
    ok = [r for r in recs if r.get("status") == "ok"]
    if rc != 0 or len(ok) != 4 * len(P16_ARCHS):
        raise AssertionError(f"phase 16 (b): the dry run exited {rc} with "
                             f"{len(ok)}/{4 * len(P16_ARCHS)} cases [OK]: "
                             + "; ".join(r.get("error", "") for r in recs
                                         if r.get("status") != "ok"))
    # (b) the reduced plans of the six families on the (2, 2) mesh
    with open(os.path.join(ROOT, "build", "phase16-reduced.json")) as fh:
        reduced = json.load(fh)
    bad = {case: r for case, r in reduced.items() if r["status"] != "ok"}
    want = len(P16_FAMILIES) * len(P16_KINDS)
    if bad or len(reduced) != want:
        raise AssertionError(f"phase 16 (b): {len(reduced) - len(bad)}/{want} "
                             f"reduced plans [OK]: {bad}")
    for case, r in reduced.items():
        log(f"  [OK]   reduced {case} x (2, 2): {r['flops']:.4e} FLOPs, "
            f"{r['bytes']:.4e} B, {r['collectives']} collectives, traced in "
            f"{r['s']:.1f} s on the host")
    out["reduced_plans"] = reduced
    out["dryrun"] = {"waited_s": waited, "cases": {}}
    for r in ok:
        a = analyze_record(r)
        out["dryrun"]["cases"][f"{r['arch']} x {r['shape']}"] = {
            **{k: a[k] for k in ("compute_s", "memory_s", "collective_s",
                                 "dominant", "useful_ratio")},
            "trace_s": r["compile_seconds"],
            "argument_bytes": r["memory"]["argument_size_in_bytes"],
            "temp_bytes": r["memory"]["temp_size_in_bytes"]}
        log(f"  [OK]   {r['arch']} x {r['shape']} x 16x16: compute "
            f"{a['compute_s']:.4g} s, memory {a['memory_s']:.4g} s, collective "
            f"{a['collective_s']:.4g} s ({a['dominant']}), useful "
            f"{a['useful_ratio']:.2f}, traced in {r['compile_seconds']:.1f} s "
            f"on the host")
    # (c) the examples, launches counted from 0
    counts_zero(wt)
    for name, (argv, headline) in P16_EXAMPLES.items():
        t0 = time.perf_counter()
        _, text = run_example(name, argv, dev.type)
        dt = time.perf_counter() - t0
        lines = [ln for ln in text.splitlines() if headline in ln]
        if not lines:
            raise AssertionError(f"example {name}: no line with {headline!r}")
        out["examples"][name] = {"s": dt, "argv": list(argv),
                                 "headline": lines[-1].strip()}
        log(f"  example {name} {' '.join(argv)} ({dt:.1f} s): {lines[-1].strip()}")
    out["examples_launches"] = counts_read(wt)
    return out


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
    start_phase16_dryrun()

    # -- build ------------------------------------------------------------------
    t0 = time.perf_counter()
    build_logs = _build.build()
    dt = time.perf_counter() - t0
    for name, text in build_logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("registers", "spill", "error", "arning",
                                       "setmaxnreg", "wgmma")):
                log(f"  nvcc {name}: {line.strip()}")
            if ((name.startswith("walk_transition")
                 or name in ("flash_attention", "ssd_scan"))
                    and "spill" in line and not line.strip().endswith(
                        "0 bytes spill stores, 0 bytes spill loads")):
                raise AssertionError(f"{name} spills: {line.strip()}")
    hgmma = sass_count("flash_attention_wgmma", "HGMMA")
    log(f"  cuobjdump -sass flash_attention_wgmma: {hgmma} HGMMA instructions")
    if hgmma == 0:
        raise AssertionError("the bf16 flash_attention library has no HGMMA")
    # the mma_sync attention kernel on the tensor cores: HMMA in bf16 and
    # float16 (m16n8k16) and in TF32 (m16n8k8, its float32 build)
    fa_hmma = {op.strip(): sass_count("flash_attention", op) for op in (
        "HMMA.16816.F32.BF16", "HMMA.16816.F32 ", "HMMA.1688.F32.TF32")}
    log(f"  cuobjdump -sass flash_attention: {fa_hmma}")
    if not all(fa_hmma.values()):
        raise AssertionError(f"the mma_sync flash_attention library lacks a "
                             f"tensor-core product: {fa_hmma}")
    # HMMA (mma.sync) or HGMMA (wgmma): the bf16 SSD scan on the tensor cores
    ssd_mma = sass_count("ssd_scan_mma", "HMMA") + sass_count("ssd_scan_mma", "HGMMA")
    log(f"  cuobjdump -sass ssd_scan_mma: {ssd_mma} HMMA/HGMMA instructions")
    if ssd_mma == 0:
        raise AssertionError("the bf16 ssd_scan library has no HMMA or HGMMA")
    # the split-TF32 SSD scan on the tensor cores: HMMA on TF32 (m16n8k8)
    ssd_tf32 = sass_count("ssd_scan", "HMMA.1688.F32.TF32")
    log(f"  cuobjdump -sass ssd_scan: {ssd_tf32} HMMA.1688.F32.TF32 instructions")
    if ssd_tf32 == 0:
        raise AssertionError("the mma_tf32 ssd_scan library has no TF32 HMMA")
    log(f"phase build: {len(_build.SOURCES)} kernel source(s), "
        f"{len(build_logs)} compiled, {dt:.2f} s")
    report["phases"]["build_s"] = dt
    report["phases"]["hgmma"] = hgmma
    report["phases"]["flash_hmma"] = fa_hmma
    report["phases"]["ssd_hmma"] = ssd_mma
    report["phases"]["ssd_tf32_hmma"] = ssd_tf32

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

    # -- phase 12: walk-routed serving ---------------------------------------
    t0 = time.perf_counter()
    p12 = phase_routed_serving(dev, smi, p10)
    dt = time.perf_counter() - t0
    log(f"phase 12 walk-routed serving: {dt:.2f} s (aim {PHASE12_AIM_S:.0f} s)")
    report["phases"]["routed_serving"] = {"s": dt, **p12}

    # -- phase 13: walk-orchestrated LLM training ------------------------------
    t0 = time.perf_counter()
    p13 = phase_llm_training(dev, smi)
    dt = time.perf_counter() - t0
    log(f"phase 13 LLM training: {dt:.2f} s (aim {PHASE13_AIM_S:.0f} s)")
    report["phases"]["llm_training"] = {"s": dt, **p13}

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
    # float32 inputs take the mma.sync kernel (the float32 prefill gate)
    flash["routes"] = {
        "wgmma_bf16": {"source": flash["source"],
                       "launches": mini["prefill"]["routes"]["wgmma_bf16"],
                       **mini["kernel"]["routes"]["wgmma_bf16"]},
        "mma_sync": {"source": "src/repro_torch/csrc/flash_attention.cu",
                     "launches": mini["prefill"]["f32_routes"]["mma_sync"],
                     **mini["kernel"]["routes"]["mma_sync"]},
    }
    ssd = llm_entry(
        "ssd_scan", "src/repro_torch/csrc/ssd_scan_mma.cu",
        "src/repro/kernels/ssd/kernel.py:74",
        mamba["prefill"]["ssd_routes"]["mma_bf16"], mamba["kernel"],
        mamba["kernel"]["max_abs_err"],
    )
    # float32 inputs take the split-TF32 kernel (the float32 prefill gate)
    ssd["routes"] = {
        "mma_bf16": {"source": ssd["source"],
                     "launches": mamba["prefill"]["ssd_routes"]["mma_bf16"],
                     **mamba["kernel"]["routes"]["mma_bf16"]},
        "mma_tf32": {"source": "src/repro_torch/csrc/ssd_scan.cu",
                     "launches": mamba["prefill"]["f32_ssd_routes"]["mma_tf32"],
                     **mamba["kernel"]["routes"]["mma_tf32"]},
    }
    # the float16 prefill leg of phase 7 rides the 16-bit routes
    flash["routes"]["wgmma_bf16"]["launches_float16"] = (
        mini["prefill"]["float16"]["routes"]["wgmma_bf16"])
    ssd["routes"]["mma_bf16"]["launches_float16"] = (
        mamba["prefill"]["float16"]["ssd_routes"]["mma_bf16"])
    # phase 6's widened shapes, each held against its plain version with
    # one launch on its route (comparisons: not counted in "launches")
    flash["widths"] = p6["widths"]["flash_attention"]
    ssd["widths"] = p6["widths"]["ssd_scan"]
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
    kernels[-1]["widths"] = p6["widths"]["rmsnorm_fused"]
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
    # phase 12's paths (the routing ticks), each counted from 0 just before
    # it and read just after; the fault sweep's serving leg is in phase 10's
    p12_paths = {"routed_main": [p12["routed_main"]["launches"]],
                 "card_vs_cpu": [p12["card_vs_cpu"][tag]["launches"]
                                 for tag in ("fault_free", "markov_5_2")],
                 "serve_throughput": [p12["serve_throughput"]["launches"]]}
    for k in kernels:
        by_path = {path: sum(c.get(k["name"], 0) for c in counts)
                   for path, counts in p12_paths.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        if by_path:
            k["launches_phase12"] = by_path
            k["launches"] += sum(by_path.values())
    if not next(k for k in kernels
                if k["name"] == "walk_transition_ragged").get("launches_phase12"):
        raise AssertionError("phase 12 launched walk_transition_ragged no time")
    # phase 13's paths (one sparse launch a train step, one a fleet step),
    # each counted from 0 just before it and read just after
    p13_paths = {"train_main": [p13["main"]["launches"]],
                 "dense_steps": [p13["dense"]["launches"]],
                 "fleet": [p13["fleet"]["launches"]],
                 "card_vs_cpu": [v["launches"] for k, v in
                                 p13["card_vs_cpu"].items() if k != "gates"],
                 "resume": [p13["resume"]["launches"]]}
    for k in kernels:
        by_path = {path: sum(c.get(k["name"], 0) for c in counts)
                   for path, counts in p13_paths.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        if by_path:
            k["launches_phase13"] = by_path
            k["launches"] += sum(by_path.values())
    if not next(k for k in kernels
                if k["name"] == "walk_transition_sparse").get("launches_phase13"):
        raise AssertionError("phase 13 launched walk_transition_sparse no time")
    # -- phase 14: the MoE, hybrid and audio families ----------------------
    t0 = time.perf_counter()
    p14 = phase_families(dev, smi)
    dt = time.perf_counter() - t0
    log(f"phase 14 MoE, hybrid, audio: {dt:.2f} s (aim {PHASE14_AIM_S:.0f} s)")
    report["phases"]["families"] = {"s": dt, **p14}
    # phase 14's paths: jamba's prefill (one ssd_scan a mamba sublayer) and
    # the training steps (one sparse launch a step), each counted from 0
    # just before it and read just after
    ssd["launches_phase14"] = {
        "jamba_prefill": p14["jamba"]["prefill"]["launches"]["ssd_scan"]}
    ssd["launches"] += ssd["launches_phase14"]["jamba_prefill"]
    ssd["routes"]["mma_bf16"]["launches"] += ssd["launches_phase14"]["jamba_prefill"]
    ssd["jamba"] = {k: p14["jamba"]["kernel"][k] for k in (
        "ms", "plain_ms", "bound_ms", "bound_by", "max_abs_err", "shape",
        "head_major_ms", "path_ms", "path_bound_share")}
    ssd["max_abs_err"] = max(ssd["max_abs_err"], p14["jamba"]["kernel"]["max_abs_err"])
    p14_paths = {"train_main": [p14["train_main"]["launches"]],
                 "train_card_vs_cpu": [v["launches"] for k, v in
                                       p14["train_card_vs_cpu"].items()
                                       if k != "gates"],
                 "fleet": [p14["fleet"]["launches"]],
                 "resume": [p14["resume"]["launches"]]}
    for k in kernels:
        by_path = {path: sum(c.get(k["name"], 0) for c in counts)
                   for path, counts in p14_paths.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        if by_path:
            k["launches_phase14"] = {**k.get("launches_phase14", {}), **by_path}
            k["launches"] += sum(by_path.values())
    if not ssd["launches_phase14"]["jamba_prefill"]:
        raise AssertionError("phase 14 launched ssd_scan no time")
    if not next(k for k in kernels
                if k["name"] == "walk_transition_sparse").get("launches_phase14"):
        raise AssertionError("phase 14 launched walk_transition_sparse no time")
    # -- phase 15: the walker fleet across ranks -----------------------------
    t0 = time.perf_counter()
    p15 = phase_fleet_mesh(dev, smi, ttrain, params)
    dt = time.perf_counter() - t0
    log(f"phase 15 walker fleet across ranks: {dt:.2f} s (aim "
        f"{PHASE15_AIM_S:.0f} s)")
    report["phases"]["fleet_mesh"] = {"s": dt, **p15}
    # phase 15's paths, each counted from 0 just before it and read just
    # after; the gloo ranks' counts are each process's own
    ranks = [r for world in P15_RANKS for r in p15["ranks"][f"P{world}"]["ranks"]]
    p15_paths = {
        "mesh_trainer": [p15["mesh_trainer"]["launches"]],
        "fleet_rows": [{"walk_transition_ragged": r["launches"]}
                       for r in p15["sweep"]["rows"].values()],
        "convergence": [{"walk_transition_sparse": c["launches"]}
                        for c in p15["sweep"]["convergence"].values()],
        "gloo_ranks": [{"walk_transition_ragged": r[k]["launches"]}
                       for r in ranks for k in ("plain", "faulted", "odd")],
        "gloo_llm_fleet": [{"walk_transition_sparse": n}
                           for a in p15["ranks"]["P2"]["llm"].values()
                           for n in a["launches_per_rank"]],
        "multi_walk": [{"walk_transition_sparse": p15["multi_walk"]["launches"]}]}
    for k in kernels:
        by_path = {path: sum(c.get(k["name"], 0) for c in counts)
                   for path, counts in p15_paths.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        if by_path:
            k["launches_phase15"] = by_path
            k["launches"] += sum(by_path.values())
    for name in ("walk_transition_sparse", "walk_transition_ragged"):
        if not next(k for k in kernels if k["name"] == name).get(
                "launches_phase15"):
            raise AssertionError(f"phase 15 launched {name} no time")
    # -- phase 16: the dry-run and roofline tooling ------------------------
    t0 = time.perf_counter()
    p16 = phase_tooling(dev, smi)
    dt = time.perf_counter() - t0
    log(f"phase 16 dry run, roofline and examples: {dt:.2f} s (aim "
        f"{PHASE16_AIM_S:.0f} s)")
    report["phases"]["tooling"] = {"s": dt, **p16}
    # phase 16's paths, each counted from 0 just before it and read just
    # after: (a)'s kernel-path prefills and (c)'s examples
    p16_paths = {"plan_vs_card": [v["launches"] for v in p16["plans"].values()],
                 "examples": [p16["examples_launches"]]}
    for k in kernels:
        by_path = {path: sum(c.get(k["name"], 0) for c in counts)
                   for path, counts in p16_paths.items()}
        by_path = {path: n for path, n in by_path.items() if n}
        if by_path:
            k["launches_phase16"] = by_path
            k["launches"] += sum(by_path.values())
    for name in ("flash_attention", "ssd_scan", "walk_transition_sparse",
                 "walk_transition_ragged"):
        if not next(k for k in kernels if k["name"] == name).get(
                "launches_phase16"):
            raise AssertionError(f"phase 16 launched {name} no time")
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
    if sys.argv[1:] == ["--phase16-plans"]:  # the CPU process of phase 16
        sys.exit(phase16_plans())
    sys.exit(main())
