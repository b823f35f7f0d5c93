"""Run the PyTorch/CUDA port on one NVIDIA GPU and check it end to end.

    python3 chip_smoke.py

Builds every CUDA kernel of the port from ``src/repro_torch/csrc`` (one
``nvcc`` per source, started together), then:

1. holds ``walk_transition_ragged`` against its plain PyTorch version on
   the card, on ``barabasi_albert(1_000_000, 3)`` (ragged, ~7 M directed
   edges) with W=8192 walks and MHLJParams(0.1, 0.5, 3), then at W=257
   with r=1 and r=5, and measures over 10^6 draws how often the kernel's
   Lévy distance d differs from PyTorch's on the card and on the CPU;
2. runs ``WalkEngine.run`` for 200 steps on that graph (launch count,
   walk-steps/s, and the kernel's own time replayed on the run's inputs),
   then a 50-step run under ``torch.profiler`` for the device's idle share;
3. trains ``run_rw_sgd_multi("mhlj", ...)`` on ``barabasi_albert(100_000,
   3)`` with W=2048, avg_every=50, 500 steps, replays every step's exact
   kernel inputs through the kernel and its plain version, and checks the
   trainer against its CPU run on a small input.

Prints one line per phase, the card's name and power limit, one JSON line
of kernel measurements, and as its last line
``{"ok": true, "device": {...}}``.  Any failed check raises and the exit
code is non-zero.  Without a CUDA device it exits non-zero and prints no
result.  Full numbers also go to ``chiprun_out/chip_smoke.json``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

# H100 SXM published peaks (NVIDIA data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
SECTOR = 32


def log(msg: str) -> None:
    print(msg, flush=True)


def device_time_ms(fn, iters: int) -> tuple:
    """Device milliseconds per call of ``fn(i)``, with the host's launch
    overhead kept out: a spin kernel holds the stream while the host
    enqueues every call between its own pair of CUDA events, so the pairs
    time back-to-back device work.  Returns ``(device ms per call, host
    enqueue ms per call, device idle ms between calls in total)``.
    """
    fn(0)
    torch.cuda.synchronize()
    probe = min(iters, 5)
    t = time.perf_counter()
    for i in range(probe):
        fn(i)
    torch.cuda.synchronize()
    host_ms = (time.perf_counter() - t) * 1e3 / probe
    starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
    # at most 2 GHz, so this spins at least 1.5x the expected enqueue time
    torch.cuda._sleep(int(host_ms * iters * 1.5 * 2.0e6) + 2_000_000)
    t = time.perf_counter()
    for i in range(iters):
        starts[i].record()
        fn(i)
        ends[i].record()
    enqueue_ms = (time.perf_counter() - t) * 1e3 / iters
    torch.cuda.synchronize()
    per_call = sum(s.elapsed_time(e) for s, e in zip(starts, ends)) / iters
    idle = sum(e.elapsed_time(s) for e, s in zip(ends[:-1], starts[1:]))
    return per_call, enqueue_ms, idle


def profile_window(fn, kernel_name: str) -> dict:
    """Device busy and idle share of ``fn()`` from a ``torch.profiler``
    trace, and the named kernel's device time per launch.

    The window runs from the first device activity to the last; idle is the
    part of it that no kernel, copy or fill covers.  Returns all None when
    the profiler records no device activity.
    """
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev_events = [e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev_events)
    by_name: dict = {}
    for e in dev_events:
        by_name[e.name] = by_name.get(e.name, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3
    # the kernel's event name is its demangled signature
    mine = [e.time_range.end - e.time_range.start for e in dev_events
            if kernel_name in e.name]
    if not spans:
        return {"window_ms": None, "busy_ms": None, "idle_share": None,
                "kernel_ms": None, "kernel_launches": 0, "device_ms_by_name": {}}
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
            "kernel_launches": len(mine), "device_ms_by_name": by_name}


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

    Mirrors the kernel's loads: a walk whose flag is 0 reads its row
    pointer, degree, row total, the binary-search probes it executes and
    one neighbor id; a jumping walk reads degree, row pointer and neighbor
    id for each of its d hops.  Scattered loads count one 32-byte sector
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
            if "registers" in line or "spill" in line or "error" in line:
                log(f"  nvcc {name}: {line.strip()}")
    log(f"phase build: {len(_build.SOURCES)} kernel source(s), "
        f"{len(build_logs)} compiled, {dt:.2f} s")
    report["phases"]["build_s"] = dt

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
    for w, r in ((8192, 3), (257, 1), (257, 5)):
        nodes = torch.randint(0, g.n, (w,), generator=gen, device=dev,
                              dtype=torch.int32)
        nodes[: w // 16 + 1] = int(np.argmax(g.degrees))  # hub walks
        u = teng.draw_uniforms(w, r, params.p_j if r == 3 else 0.5, gen, dev)
        args = (nodes, eng.indptr, eng.degrees, eng.indices, eng.edge_cdf, u)
        kw = dict(p_d=params.p_d, r=r, max_degree=eng.max_degree)
        nxt_k, hops_k = wt.walk_transition_ragged(*args, **kw)
        nxt_p, hops_p = walk_transition_ragged_ref(*args, **kw)
        c = compare_with_plain(nxt_k, hops_k, nxt_p, hops_p, u,
                               f"at W={w} r={r}")
        phase1.append({"w": w, "r": r, **c})
        log(f"  kernel vs plain W={w} r={r}: bitwise on "
            f"{w - c['d_differs']}/{w} walks, d differs on {c['d_differs']} "
            f"of {c['jumps']} jumps, max abs err {c['max_abs_err']}")
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
    gen.manual_seed(7)
    wt.walk_transition_ragged.launches = 0
    ev0, ev1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    ev0.record()
    update_nodes, hops = eng.run(v0, steps, generator=gen)
    ev1.record()
    torch.cuda.synchronize()
    launches = wt.walk_transition_ragged.launches
    if launches != steps:
        raise AssertionError(f"engine run launched the kernel {launches} "
                             f"times in {steps} steps")
    run_ms = ev0.elapsed_time(ev1)
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
    kernel_ms, kernel_host_ms, kernel_idle = device_time_ms(
        lambda i: wt.walk_transition_ragged(cur[i], *kargs, blocks[i], **kw),
        steps,
    )
    plain_ms, plain_host_ms, plain_idle = device_time_ms(
        lambda i: walk_transition_ragged_ref(cur[i], *kargs, blocks[i], **kw),
        50,
    )
    gen.manual_seed(7)
    prof = profile_window(lambda: eng.run(v0, 50, generator=gen),
                          "walk_transition_ragged_kernel")
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
    dt = time.perf_counter() - t0
    log(f"  engine run W={w} T={steps}: {launches} launches, "
        f"{rate:.4e} walk-steps/s ({run_ms / steps:.4f} ms/step), "
        f"hops/update {hops_mean:.4f}")
    log(f"  kernel {kernel_ms:.5f} ms/launch on the device (host enqueue "
        f"{kernel_host_ms:.5f} ms/call, device idle between launches "
        f"{kernel_idle:.4f} ms in all), plain {plain_ms:.5f} ms (host "
        f"{plain_host_ms:.5f} ms/call, idle {plain_idle:.4f} ms in all), "
        f"bound {bound_ms:.6f} ms ({nbytes / steps:.0f} B/step over HBM; "
        f"ops bound {ops_ms:.2e} ms)")
    if prof["window_ms"] is None:
        log("  profiler: no device activity recorded; idle share not measured")
    else:
        log(f"  profiler, 50-step run: window {prof['window_ms']:.4f} ms, "
            f"device busy {prof['busy_ms']:.4f} ms, idle share "
            f"{prof['idle_share']:.4f}, kernel {prof['kernel_ms']} ms/launch "
            f"over {prof['kernel_launches']} launches")
    log(f"phase 2 engine: {dt:.2f} s")
    report["phases"]["engine"] = {
        "s": dt, "w": w, "steps": steps, "launches": launches,
        "run_ms": run_ms, "walk_steps_per_s": rate, "kernel_ms": kernel_ms,
        "kernel_host_ms": kernel_host_ms, "kernel_idle_ms": kernel_idle,
        "plain_ms": plain_ms, "plain_host_ms": plain_host_ms,
        "plain_idle_ms": plain_idle, "bound_ms": bound_ms, "bytes_per_step":
        nbytes / steps, "ops_per_step": nops / steps, "hops_mean": hops_mean,
        "profile_50_steps": prof,
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
    seen: dict = {}
    run_fleet = ttrain.run_fleet

    def timed_run_fleet(*args, **kw):
        torch.cuda.synchronize()
        seen["enter"] = time.perf_counter()
        seen["fleet"], seen["p_j_sched"] = args[4], args[7]
        seen["gen_state"] = kw["generator"].get_state()
        out = run_fleet(*args, **kw)
        torch.cuda.synchronize()
        seen["loop_s"] = time.perf_counter() - seen["enter"]
        return out

    ttrain.run_fleet = timed_run_fleet
    try:
        wt.walk_transition_ragged.launches = 0
        t_train = time.perf_counter()
        res = run_rw_sgd_multi(
            "mhlj", g3, data, gamma, steps3, w3, mhlj_params=params,
            avg_every=50, seed=0, device=dev,
        )
        t_end = time.perf_counter()
        train_launches = wt.walk_transition_ragged.launches
    finally:
        ttrain.run_fleet = run_fleet
    t_setup = seen["enter"] - t_train
    t_loop = seen["loop_s"]
    t_train = t_end - t_train
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
    log(f"  trainer mhlj BA(100k,3) W={w3} T={steps3}: {train_launches} "
        f"launches, avg_mse {avg[0]:.4f} -> {avg[steps3 // 2]:.4f} -> "
        f"{avg[-1]:.4f} (least-squares floor {floor:.4f}), "
        f"hops/update {res.transitions_per_update:.4f}, {t_train:.2f} s "
        f"(set-up: P_IS rows on the host and CDF on the device "
        f"{t_setup:.2f} s; loop {t_loop / steps3 * 1e3:.4f} ms/step)")
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
    for t in range(steps3):
        u = teng.draw_uniforms(w3, e3.r, seen["p_j_sched"][t], g_rep, dev)
        cur = nodes3[:, t].contiguous()
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
    }]
    report["kernels"] = kernels
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "chip_smoke.json"), "w") as fh:
        json.dump(report, fh, indent=1)
    log(f"kernels: walk_transition_ragged launches={train_launches}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
