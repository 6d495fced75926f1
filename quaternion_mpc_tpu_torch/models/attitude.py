"""Airborne attitude-control model: the ``falling_cat`` branch config (port of
`quaternion_mpc_tpu/models/attitude.py`).

The reference repo's ``falling_cat`` branch (README.md:20-25) reuses the
quaternion-MPC solver core for contact-free attitude control with large
quaternion errors: reduced state x = [q(4), ω(3)] (quat_idx=0, error dim 6),
input u = body torque (3,) realized by leg inertia, dynamics

    q̇ = ½ G(q) ω,   ω̇ = I⁻¹ (u − ω × Iω)

with box torque limits as the linear input inequality. It is also the
solver's large-error stress test: the Cayley-chart error state handles
initial attitudes ~180° from the goal without singularities.

`attitude_dynamics_fleet` is batch-last, x (..., 7, B), inertia (3, 3, B|1);
`attitude_dynamics` is its single view. The model has no analytic Jacobian:
the solver differentiates it by `torch.func.jacfwd`, so it is built from
`stack` / `cat` (see `models`), and I⁻¹ is the closed-form 3x3 inverse (a
`torch.linalg.solve` on the card checks its pivots on the host).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch.models import single_view
from quaternion_mpc_tpu_torch.models.srb import _inv3_bl, _quat_G_bl
from quaternion_mpc_tpu_torch.ops.lie import cross


class AttitudeParams(NamedTuple):
    inertia: torch.Tensor  # (3, 3)


def go1_attitude_params(*, dtype: torch.dtype, device=None) -> AttitudeParams:
    inertia = (12.84 / 5.204) * np.diag([0.0168128557, 0.063009565, 0.0716547275])
    return AttitudeParams(inertia=_bridge.tensor(inertia, device, dtype))


def attitude_dynamics_fleet(x: torch.Tensor, u: torch.Tensor, p: AttitudeParams) -> torch.Tensor:
    """x = [q, ω] (..., 7, B), u = body torque (..., 3, B). Full gyroscopic
    term retained (airborne, no contact forces to dominate it)."""
    q = x[..., 0:4, :]
    omega = x[..., 4:7, :]
    q_dot = 0.5 * torch.sum(_quat_G_bl(q) * omega.unsqueeze(-3), dim=-2)
    I_omega = torch.sum(p.inertia * omega.unsqueeze(-3), dim=-2)
    moment = u - cross(omega, I_omega, dim=-2)
    omega_dot = torch.sum(_inv3_bl(p.inertia) * moment.unsqueeze(-3), dim=-2)
    return torch.cat([q_dot, omega_dot], dim=-2)


attitude_dynamics = single_view(attitude_dynamics_fleet)
# the tag of the model in K2 (kernels/line_search.py), which runs its line
# search under the midpoint rule
attitude_dynamics.line_search = "attitude"
# K8's tag (kernels/expansions.py): its knot expansions of a spec that
# differentiates the model (no fj), under the midpoint rule
attitude_dynamics.expansions = "attitude"


def torque_box(tau_max: float, *, dtype: torch.dtype, device=None):
    """|τ_i| ≤ τ_max as Cu·u + cb ≤ 0 rows."""
    device = _bridge.resolve_device(device)
    eye = torch.eye(3, dtype=dtype, device=device)
    Cu = torch.cat([eye, -eye], dim=0)
    cb = torch.full((6,), -tau_max, dtype=dtype, device=device)
    return Cu, cb
