"""Node and link faults for the walk stack: the liveness layer.

The port of ``repro.core.faults``.  A crashed hub or a cut bridge traps a
walk outright, not just with high probability.  This module holds the
seeded fault process that the engine (:meth:`WalkEngine.step` with
``faults=``) and the fleet loop (``walk_sgd.fleet.run_fleet``) thread
through; ``docs/faults.md`` states the semantics:

* :class:`FaultModel` — the fault *law*: a per-node two-state Markov
  up/down process (``crash_rate`` up→down, ``recovery_rate`` down→up, per
  tick), scripted node windows (node ``v`` is down while ``down_at[v] <= t
  < up_at[v]``) and, on the ragged layout, scripted windows per CSR edge
  slot.  Rates, ``patience`` and ``rescue`` are Python values; the
  scripted windows are int32 device tensors.
* :class:`FaultState` — the per-tick carry: the Markov liveness ``live``
  (n,) bool, the per-walk consecutive ``blocked`` (W,) int32 counter and
  the tick ``t``, a 0-d int32, all device tensors.
* :func:`apply_liveness` — the rejection rule: a handoff whose endpoint is
  dead (or whose traversed edge is dropped) is rejected like an MH
  rejection; the walker stays, pays its attempted hops, and its counter
  grows.  At ``patience`` the **jump rescue** moves it to a uniform live
  node (:func:`live_uniform_choice`) at a cost of ``r`` hops.

Randomness: :meth:`FaultModel.advance` takes ``(n,)`` uniforms and
:func:`apply_liveness` ``(W,)`` uniforms, each injected (the parity tests
feed the reference's draws) or drawn from a ``torch.Generator``.  Nothing
here reads the device on the host: the rescue's "any live node" gate is a
device bool inside ``torch.where``, so the faulted step can be captured.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

__all__ = [
    "NEVER",
    "FaultModel",
    "FaultState",
    "apply_liveness",
    "live_uniform_choice",
    "edge_slot_lookup",
    "kill_top_hubs",
    "partition_groups",
    "dumbbell_bridge_mask",
]

# scripted-window sentinel: a node or edge with down_at == NEVER never faults
NEVER = int(np.iinfo(np.int32).max)

# every prefix of a 0/1 float32 cumsum is exact below 2^24
_MAX_LIVE_NODES = 2**24


def _uniforms(shape, uniforms, generator, device) -> torch.Tensor:
    """An injected float32 block of ``shape``, or a draw from ``generator``."""
    if uniforms is not None:
        u = torch.as_tensor(uniforms, dtype=torch.float32, device=device)
        if tuple(u.shape) != tuple(shape):
            raise ValueError(f"uniforms must have shape {tuple(shape)}, got "
                             f"{tuple(u.shape)}")
        return u
    if generator is None:
        raise ValueError("pass uniforms= (injected) or generator=")
    return torch.rand(shape, generator=generator, device=device)


@dataclasses.dataclass(frozen=True, eq=False)
class FaultState:
    """Per-tick fault carry.  ``live`` is the Markov component only; the
    effective mask is :meth:`FaultModel.live_mask`, which also applies the
    scripted windows at tick ``t``."""

    live: torch.Tensor  # (n,) bool
    blocked: torch.Tensor  # (W,) int32 consecutive fault-blocked steps
    t: torch.Tensor  # () int32 tick index


@dataclasses.dataclass(frozen=True, eq=False)
class FaultModel:
    """Seeded fault law: Markov node churn and scripted node/edge windows.

    ``crash_rate``/``recovery_rate`` are per-tick probabilities (steady
    down fraction ``crash / (crash + recovery)``, mean downtime ``1 /
    recovery`` ticks).  ``down_at``/``up_at`` (n,) script node ``v`` down
    during ``[down_at[v], up_at[v])``; ``edge_down_at``/``edge_up_at``
    (nnz,) do the same per CSR edge slot (ragged layout only).  A walker
    blocked ``patience`` consecutive steps is force-jumped to a uniform
    live node when ``rescue`` is on, and stays parked when it is off.
    """

    crash_rate: float = 0.0
    recovery_rate: float = 0.0
    down_at: Optional[torch.Tensor] = None  # (n,) int32, NEVER = no fault
    up_at: Optional[torch.Tensor] = None  # (n,) int32
    edge_down_at: Optional[torch.Tensor] = None  # (nnz,) int32 per CSR slot
    edge_up_at: Optional[torch.Tensor] = None  # (nnz,) int32
    patience: int = 3
    rescue: bool = True

    def __post_init__(self):
        if (self.down_at is None) != (self.up_at is None):
            raise ValueError("down_at and up_at must be given together")
        if (self.edge_down_at is None) != (self.edge_up_at is None):
            raise ValueError(
                "edge_down_at and edge_up_at must be given together"
            )
        if self.patience < 1:
            raise ValueError(f"patience must be >= 1, got {self.patience}")

    @property
    def markov(self) -> bool:
        """Whether :meth:`advance` draws: a rate is positive."""
        return self.crash_rate > 0.0 or self.recovery_rate > 0.0

    def to(self, device) -> "FaultModel":
        """This model with its scripted windows as int32 tensors on
        ``device``."""
        def move(x):
            if x is None:
                return None
            if isinstance(x, torch.Tensor):
                return x.to(device=device, dtype=torch.int32)
            return torch.as_tensor(np.asarray(x).astype(np.int32),
                                   device=device)

        return dataclasses.replace(
            self, down_at=move(self.down_at), up_at=move(self.up_at),
            edge_down_at=move(self.edge_down_at),
            edge_up_at=move(self.edge_up_at),
        )

    # -- state ---------------------------------------------------------------
    def init_state(self, num_nodes: int, num_walks: int, *,
                   start: int = 0, device="cuda") -> FaultState:
        """All live, counters at 0, tick ``start``."""
        return FaultState(
            live=torch.ones(num_nodes, dtype=torch.bool, device=device),
            blocked=torch.zeros(num_walks, dtype=torch.int32, device=device),
            t=torch.full((), start, dtype=torch.int32, device=device),
        )

    def advance(self, state: FaultState, *, uniforms=None,
                generator: Optional[torch.Generator] = None) -> FaultState:
        """One tick of the Markov process; ``blocked`` rides through.

        Draws ``(n,)`` uniforms (injected or from ``generator``) only when
        a rate is positive, as the reference draws its key only then.
        """
        live = state.live
        if self.markov:
            u = _uniforms(live.shape, uniforms, generator, live.device)
            crash = u < float(np.float32(self.crash_rate))
            recover = u < float(np.float32(self.recovery_rate))
            live = torch.where(live, ~crash, recover)
        return FaultState(live=live, blocked=state.blocked, t=state.t + 1)

    # -- masks ---------------------------------------------------------------
    def live_mask(self, state: FaultState) -> torch.Tensor:
        """(n,) bool effective liveness: Markov AND the scripted windows."""
        live = state.live
        if self.down_at is not None:
            live = live & ~((self.down_at <= state.t) & (state.t < self.up_at))
        return live

    def edge_live_mask(self, state: FaultState) -> Optional[torch.Tensor]:
        """(nnz,) bool per-slot edge liveness, or None without edge faults."""
        if self.edge_down_at is None:
            return None
        return ~((self.edge_down_at <= state.t) & (state.t < self.edge_up_at))


# -- the rejection and rescue (the engine calls these after its dispatch) ----


def live_uniform_choice(u: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """Uniform draw over the live nodes — the rescue's destination law.

    The inverse CDF of the 0/1 liveness weights: ``cdf`` puts a unit step
    at every live node (an int32 prefix sum, cast to float32: every prefix
    is an exact integer below 2^24, so these are the bits of a float32
    cumsum in any order), and ``searchsorted(cdf, u * cdf[-1], right)``
    lands uniformly on live nodes.  Without a live node the draw means
    nothing; :func:`apply_liveness` gates on that.
    """
    n = live.shape[0]
    if n > _MAX_LIVE_NODES:
        raise ValueError(f"n={n} exceeds 2^24, where a float32 prefix sum "
                         "of 0/1 weights stops being exact")
    cdf = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32).to(
        torch.float32)
    tgt = u * cdf[-1]
    idx = torch.searchsorted(cdf, tgt, right=True)
    return torch.clamp(idx, 0, n - 1).to(torch.int32)


def edge_slot_lookup(
    indptr: torch.Tensor,
    indices: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    max_degree: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Flat CSR slot of edge ``src -> dst`` per walk: ``(slot, found)``.

    Reads each source row's ``max_degree``-wide window — a ``(W,
    max_degree)`` gather — for ``dst``; the first hit is the slot.
    ``found`` is False where no such edge exists (a multi-hop jump's
    endpoint), whose ``slot`` the caller masks.
    """
    start = indptr[src]
    deg = indptr[src + 1] - start
    offs = torch.arange(max_degree, dtype=start.dtype, device=start.device)
    gather = torch.clamp(start[:, None] + offs[None, :], 0,
                         indices.shape[0] - 1)
    hit = (indices[gather] == dst[:, None]) & (offs[None, :] < deg[:, None])
    found = hit.any(dim=1)
    first = torch.argmax(hit.to(torch.uint8), dim=1)  # the first maximum
    return start + first.to(start.dtype), found


def apply_liveness(
    nodes: torch.Tensor,  # (W,) int32 positions before the step
    nxt: torch.Tensor,  # (W,) int32 proposed positions
    hops: torch.Tensor,  # (W,) int32 attempted hop cost
    blocked: torch.Tensor,  # (W,) int32 consecutive blocked counter
    live: torch.Tensor,  # (n,) bool effective liveness
    *,
    patience: int,
    rescue: bool,
    rescue_hops: int = 1,
    uniforms=None,  # (W,) rescue uniforms, or
    generator: Optional[torch.Generator] = None,
    edge_live: Optional[torch.Tensor] = None,  # (nnz,) bool
    indptr: Optional[torch.Tensor] = None,
    indices: Optional[torch.Tensor] = None,
    max_degree: Optional[int] = None,
) -> tuple:
    """Liveness-masked acceptance of one batched transition.

    A handoff is blocked when the walker's node is down, the endpoint is
    down, or (edge faults) the traversed single-hop edge is dropped.
    Blocked walkers stay, pay ``hops`` and count up ``blocked``; at
    ``patience``, with ``rescue`` on and any node live, they jump to a
    uniform live node at ``rescue_hops`` hops and the count resets.  The
    rescue's ``(W,)`` uniforms are drawn whenever ``rescue`` is on (a
    fixed consumption of the stream), injected or from ``generator``.

    Returns ``(next_nodes, hops, blocked, was_blocked, rescued)``.
    """
    self_dead = ~live[nodes]
    moved = nxt != nodes
    dst_dead = moved & ~live[nxt]
    fault_blocked = self_dead | dst_dead
    if edge_live is not None:
        if indptr is None or indices is None or max_degree is None:
            raise ValueError(
                "edge faults need flat CSR state (indptr/indices/"
                "max_degree) — only CSR-bearing engine layouts (ragged) "
                "support per-edge drop masks"
            )
        slot, found = edge_slot_lookup(indptr, indices, nodes, nxt, max_degree)
        fault_blocked = fault_blocked | (moved & found & ~edge_live[slot])
    nxt_out = torch.where(fault_blocked, nodes, nxt)
    blocked_out = torch.where(fault_blocked, blocked + 1,
                              torch.zeros_like(blocked))
    rescued = torch.zeros_like(fault_blocked)
    if rescue:
        u = _uniforms(nodes.shape, uniforms, generator, nodes.device)
        v_rescue = live_uniform_choice(u, live)
        rescued = fault_blocked & (blocked_out >= patience) & live.any()
        nxt_out = torch.where(rescued, v_rescue, nxt_out)
        hops = torch.where(rescued, torch.full_like(hops, rescue_hops), hops)
        blocked_out = torch.where(rescued, torch.zeros_like(blocked_out),
                                  blocked_out)
    return nxt_out, hops, blocked_out, fault_blocked, rescued


# -- scripted scenarios (host numpy, then device tensors) --------------------


def kill_top_hubs(
    degrees,
    k: int,
    *,
    at: int,
    duration: Optional[int] = None,
    device="cuda",
    **model_kwargs,
) -> FaultModel:
    """The ``k`` highest-degree nodes (ties by node id) crash at tick ``at``
    and recover after ``duration`` ticks (``None``: never).  Other keywords
    (rates, patience, rescue) pass through to :class:`FaultModel`."""
    deg = np.asarray(degrees)
    n = deg.shape[0]
    if not 0 < k <= n:
        raise ValueError(f"k must be in [1, {n}], got {k}")
    top = np.argsort(-deg, kind="stable")[:k]
    down_at = np.full(n, NEVER, np.int32)
    up_at = np.full(n, NEVER, np.int32)
    down_at[top] = at
    if duration is not None:
        up_at[top] = at + duration
    return FaultModel(
        down_at=torch.as_tensor(down_at, device=device),
        up_at=torch.as_tensor(up_at, device=device), **model_kwargs,
    )


def partition_groups(
    indptr,
    indices,
    side,
    *,
    at: int,
    duration: Optional[int] = None,
    device="cuda",
    **model_kwargs,
) -> FaultModel:
    """Drop every edge crossing the ``side`` cut (both CSR directions)
    during ``[at, at + duration)``; ``side`` is an (n,) bool group mask."""
    indptr_np = np.asarray(indptr)
    indices_np = np.asarray(indices)
    side = np.asarray(side, bool)
    n = indptr_np.shape[0] - 1
    if side.shape != (n,):
        raise ValueError(f"side must be an ({n},) bool mask, got {side.shape}")
    src = np.repeat(np.arange(n), np.diff(indptr_np))
    crossing = side[src] != side[indices_np]
    if not crossing.any():
        raise ValueError("side mask cuts no edge; nothing to partition")
    edge_down = np.full(indices_np.shape[0], NEVER, np.int32)
    edge_up = np.full(indices_np.shape[0], NEVER, np.int32)
    edge_down[crossing] = at
    if duration is not None:
        edge_up[crossing] = at + duration
    return FaultModel(
        edge_down_at=torch.as_tensor(edge_down, device=device),
        edge_up_at=torch.as_tensor(edge_up, device=device),
        **model_kwargs,
    )


def dumbbell_bridge_mask(n: int, clique_n: int, path_len: int = 1) -> np.ndarray:
    """Side mask splitting ``graphs.dumbbell(clique_n, path_len)`` at the
    middle of its bridge, for :func:`partition_groups`."""
    if n != 2 * clique_n + path_len:
        raise ValueError(
            f"n={n} is not a dumbbell({clique_n},{path_len}) node count "
            f"({2 * clique_n + path_len})"
        )
    side = np.zeros(n, bool)
    side[clique_n + (path_len + 1) // 2:] = True
    return side
