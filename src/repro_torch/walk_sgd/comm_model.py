"""Remark-1 communication accounting (a copy of
``repro.walk_sgd.comm_model``; all of it is arithmetic).

One *transition* = one model hand-off over a graph edge.  MHLJ trades extra
transitions (jump hops carry the model without updating it) for fewer updates
to a target accuracy.  This module turns (updates, transitions, model bytes)
into the paper's cost statement and a bytes-on-the-wire estimate.

The W-walker fleet (``repro_torch.walk_sgd.fleet``) adds a second traffic class
on top of the per-walk hand-offs: the periodic cross-walker model average,
one all-reduce along the walker mesh axis every ``avg_every`` steps.
:func:`fleet_averaging_traffic` prices it as a function of W, the mesh
size and the model size.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.levy import expected_transitions_per_update, remark1_bound

__all__ = ["CommModel", "comm_report", "fleet_averaging_traffic"]


@dataclasses.dataclass(frozen=True)
class CommModel:
    model_bytes: int  # bytes per hand-off (parameters at wire precision)
    link_bandwidth: float = 1e9  # bytes/s per edge (WAN-ish default)
    per_hop_latency: float = 1e-3  # seconds


def comm_report(
    transitions: np.ndarray,
    p_j: float,
    p_d: float,
    r: int,
    comm: CommModel | None = None,
) -> dict:
    """Measured vs predicted transitions/update + wire-cost estimate."""
    measured = float(np.asarray(transitions, dtype=np.float64).mean())
    exact = expected_transitions_per_update(p_j, p_d, r)
    bound = remark1_bound(p_j, p_d, r)
    out = {
        "transitions_per_update_measured": measured,
        "transitions_per_update_exact": exact,
        "transitions_per_update_bound": bound,
        "within_bound": bool(measured <= bound + 5e-2),
    }
    if comm is not None:
        n_hops = float(np.asarray(transitions, dtype=np.float64).sum())
        out["wire_bytes_total"] = n_hops * comm.model_bytes
        out["wire_seconds_est"] = n_hops * (
            comm.model_bytes / comm.link_bandwidth + comm.per_hop_latency
        )
    return out


def fleet_averaging_traffic(
    num_walks: int,
    num_steps: int,
    avg_every: int,
    model_bytes: int,
    *,
    mesh_devices: int = 1,
    comm: CommModel | None = None,
) -> dict:
    """Wire cost of the fleet's periodic cross-walker averaging collective.

    Every ``avg_every`` steps, ``repro_torch.walk_sgd.fleet.fleet_average``
    all-reduces one model's worth of parameters along the walker mesh
    axis.  With W walkers sharded over D devices, each device first forms
    its *local* partial mean over the walkers it hosts (free — no wire
    traffic), so the collective payload is one model regardless of W;
    only ``D_eff = min(W, D)`` devices hold walkers and participate.
    Under the standard ring all-reduce cost model each participating
    device sends ``2 * (D_eff - 1) / D_eff * model_bytes`` per
    collective, hence total wire bytes per collective are
    ``2 * (D_eff - 1) * model_bytes`` — zero on a single device, where
    the average is a local reduction.

    ``avg_every <= 0`` (never average) prices to zero collectives.  With
    ``comm``, a wall-clock estimate per collective and in total is added
    using the ring's per-device bytes plus one ``per_hop_latency`` per
    collective.  Returns a dict; see ``tests/test_torch_theory.py`` for the
    invariants (monotone in model size, zero at D=1, W-independence of
    the per-collective payload once W >= D).
    """
    if num_walks < 1 or mesh_devices < 1:
        raise ValueError("num_walks and mesh_devices must be >= 1")
    d_eff = min(num_walks, mesh_devices)
    n_collectives = num_steps // avg_every if avg_every > 0 else 0
    per_device = 2.0 * (d_eff - 1) / d_eff * model_bytes if d_eff > 1 else 0.0
    per_collective = per_device * d_eff  # == 2 * (d_eff - 1) * model_bytes
    out = {
        "num_collectives": n_collectives,
        "participating_devices": d_eff,
        "bytes_per_device_per_collective": per_device,
        "bytes_per_collective": per_collective,
        "total_wire_bytes": per_collective * n_collectives,
        # amortized collective traffic per model update across the fleet
        "bytes_per_update": (
            per_collective * n_collectives / (num_steps * num_walks)
            if num_steps > 0
            else 0.0
        ),
    }
    if comm is not None:
        secs = (
            per_device / comm.link_bandwidth + comm.per_hop_latency
            if d_eff > 1
            else 0.0
        )
        out["wire_seconds_per_collective"] = secs
        out["wire_seconds_total"] = secs * n_collectives
    return out
