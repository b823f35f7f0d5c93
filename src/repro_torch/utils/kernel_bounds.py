"""The work of each kernel of the port, and the least time the card could
take for it: the bound each kernel's row of the kernel table is held to.

Each helper returns the bytes a function must move (each input read once,
each output written once, scattered reads as whole 32-byte sectors) and
the operations it does, on the inputs or at the shape given; :func:`bound`
turns them into milliseconds at the card's HBM rate and peak operation
rate (:class:`repro_torch.launch.mesh.HW`), whichever is larger.

The walk kernels' helpers (:func:`bound_for_step`, :func:`bound_sparse`,
:func:`bound_dense`, :func:`chain_loads`) read the data: which addresses
a step touches depends on the walks.  :func:`walk_step_work` is their
shape-only count, which ``repro_torch.utils.op_cost`` prices a walk step
by when it cannot read the data (a planned step on fake tensors).
:func:`flash_bound`, :func:`ssd_bound` and :func:`rmsnorm_bound` depend
on shapes only, and ``op_cost`` prices the attention, SSD and RMSNorm
calls by them whichever implementation runs.
"""
from __future__ import annotations

import torch

from repro_torch.launch.mesh import HW

__all__ = ["SECTOR", "bound", "sectors", "bound_for_step", "chain_loads",
           "bound_sparse", "bound_dense", "flash_bound", "flash_ops_per_s",
           "ssd_bound", "ssd_ops_per_s",
           "ssd_mma_bytes", "rmsnorm_bound", "walk_step_work"]

HBM_BYTES_PER_S = HW.HBM_BW
SECTOR = 32  # bytes of one DRAM sector, the unit of a scattered read

def bound(nbytes: float, ops: float, ops_per_s: float) -> tuple:
    """``(bound ms, "bytes" or "operations")``: the larger of the bytes over
    HBM bandwidth and the operations over the peak rate."""
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / ops_per_s * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations")


def sectors(addr_bytes: torch.Tensor) -> int:
    """Distinct 32-byte sectors among byte addresses."""
    return int(torch.unique(addr_bytes // SECTOR).numel()) if addr_bytes.numel() else 0


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


def flash_ops_per_s(elt: int) -> float:
    """The peak rate attention's operations are bounded at, for elements of
    ``elt`` bytes: bf16 and float16 on the tensor cores; float32 at a third
    of TF32's rate, the least time float32-accurate products can take on
    the tensor cores (three TF32 products for each, as the ``mma_sync``
    kernel forms them)."""
    return HW.PEAK_FLOPS_TF32 / 3 if elt == 4 else HW.PEAK_FLOPS_BF16


def ssd_bound(b, h, l, p, n, q, elt, g) -> tuple:
    """``(bytes, ops)`` of one SSD scan: x, B and C at their ``g`` groups
    (what the function needs, not the kernel's head-expanded copies) and
    the float32 da, dt read once, y (float32) written once; per chunk the
    lower-triangular C.B^T and att @ x, the state term and the state
    update."""
    nbytes = b * l * (h * (p * elt + 2 * 4 + p * 4) + 2 * g * n * elt)
    pairs = q * (q + 1) / 2
    per_chunk = pairs * 2 * (n + p) + 2 * (2 * q * n * p)
    return nbytes, per_chunk * (l // q) * b * h


def ssd_ops_per_s(elt: int) -> float:
    """The peak rate the SSD scan's operations are bounded at, for x, B and
    C of ``elt`` bytes: bf16 and float16 on the tensor cores; float32 at a
    third of TF32's rate, as ``csrc/ssd_scan.cu`` forms each float32
    product from three or four TF32 products (the rate
    :func:`flash_ops_per_s` gives float32 attention)."""
    return flash_ops_per_s(elt)


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


def rmsnorm_bound(rows, d, elt) -> tuple:
    """``(bytes, ops)`` of one RMSNorm of ``(rows, d)`` elements of ``elt``
    bytes: x read and the output written once, the float32 scale once;
    4 operations an element (square, add, scale, multiply)."""
    return 2 * rows * d * elt + d * 4, 4.0 * rows * d


def walk_step_work(w, width, r, *, row_bytes=4) -> tuple:
    """``(bytes, ops)`` of one walk step of ``w`` walks at a shape-only
    count: each walk reads its node, a row of ``width`` entries of
    ``row_bytes`` and r hops (a degree, a row pointer and a neighbor id
    sector each), reads its ``3 + r`` uniforms and writes its next node
    and hop count; an add and a compare per row entry, 6 operations a
    hop and 30 for the jump length.  It does not read which walks jump
    or where: the data-dependent bounds above do."""
    nbytes = w * (4 + width * row_bytes + 3 * r * SECTOR + (3 + r) * 4 + 2 * 4)
    ops = w * (2 * width + 6 * r + 30)
    return nbytes, ops
