"""Fleet-native (batch-last) single-rigid-body models (port of
`quaternion_mpc_tpu/models/srb.py`): the quaternion SRB of the quaternion MPC
and the Euler SRB of the convex-MPC baseline, and at the end the reference's
single-problem functions as views of them.

Quaternion: x = [p(3), q(4), v(3), ω(3)] body frame, u = (3·n_feet,)
body-frame forces. Euler: x = [rpy(3), p(3), ω(3), v(3)] world frame, u
world-frame forces. Every fleet function takes x (..., nx, B) and
u (..., 3·n_feet, B): the
scenario batch is the LAST axis and any LEADING axes (the horizon knots of the
expansions, the line-search alphas of the rollouts) broadcast through. Params
broadcast on a trailing batch axis: foot_pos (n_feet, 3, B|1), inertia
(3, 3, B|1), mass (B|1,), com_offset (3, B|1), rot (3, 3, B|1).

Reference modelling choices kept for fixture fidelity (srb.py:14-19): no
gyroscopic term, the CoM gravity moment uses the trunk mass, gravity is
rotated by the frozen per-solve attitude, not the state quaternion.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch.models import single_view
from quaternion_mpc_tpu_torch.ops.lie import cross

GRAVITY = 9.81


class SrbParams(NamedTuple):
    """Frozen per-solve parameters of the SRB model.

    foot_pos: (n_feet, 3) foot positions, body frame.
    inertia: (3, 3) rigid-body inertia used in the MPC model.
    mass: total robot mass.
    com_offset: (3,) trunk CoM offset for the gravity moment.
    com_mass: mass used in the CoM gravity moment (reference uses trunk mass).
    rot_body_to_world: (3, 3) frozen attitude for the gravity projection.
    """

    foot_pos: torch.Tensor
    inertia: torch.Tensor
    mass: torch.Tensor
    com_offset: torch.Tensor
    com_mass: torch.Tensor
    rot_body_to_world: torch.Tensor

    @property
    def n_feet(self) -> int:
        return self.foot_pos.shape[-2]


def go1_params(
    foot_pos=None,
    inertia_scale: float = 12.84 / 5.204,
    mass: float = 12.84,
    rot_body_to_world=None,
    com_offset=(0.0223, 0.002, -0.0005),
    *,
    dtype: torch.dtype,
    device=None,
) -> SrbParams:
    """Go1 constants (config/gazebo_go1_quat_mpc.yaml:115-122, QuatMpc.cpp:180-182)."""
    trunk_inertia = np.diag([0.0168128557, 0.063009565, 0.0716547275])
    if foot_pos is None:
        # default stance feet, body frame (TestAltroQuatMpc.cpp:41-44)
        foot_pos = np.array(
            [
                [0.2104, 0.13, -0.325],
                [0.2104, -0.13, -0.325],
                [-0.1658, 0.13, -0.325],
                [-0.1658, -0.13, -0.325],
            ]
        )
    if rot_body_to_world is None:
        rot_body_to_world = np.eye(3)
    t = lambda a: _bridge.tensor(a, device, dtype)
    return SrbParams(
        foot_pos=t(foot_pos),
        inertia=t(inertia_scale * trunk_inertia),
        mass=t(mass),
        com_offset=t(com_offset),
        com_mass=t(5.204),
        rot_body_to_world=t(rot_body_to_world),
    )


def params_to_fleet(p: SrbParams, batch_axis: bool = False) -> SrbParams:
    """Move per-scenario SrbParams (leading batch or unbatched) to batch-last.

    Unbatched params gain a trailing broadcast axis of size 1.
    """
    if batch_axis:
        move = lambda a: torch.movedim(a, 0, -1)
        scalar = move
    else:
        move = lambda a: a[..., None]
        scalar = lambda a: torch.atleast_1d(a)[..., None]
    return SrbParams(
        foot_pos=move(p.foot_pos),
        inertia=move(p.inertia),
        mass=scalar(p.mass),
        com_offset=move(p.com_offset),
        com_mass=scalar(p.com_mass),
        rot_body_to_world=move(p.rot_body_to_world),
    )


# ---------------------------------------------------------------------------
# Batch-last building blocks
# ---------------------------------------------------------------------------


def _eye(n: int, like: torch.Tensor) -> torch.Tensor:
    """(n, n, 1) identity that broadcasts against (..., n, n, B)."""
    return torch.eye(n, dtype=like.dtype, device=like.device)[..., None]


def _mm(A, B):
    """(..., n, k, B) @ (..., k, m, B) -> (..., n, m, B) as multiply + sum."""
    return torch.sum(A.unsqueeze(-2) * B.unsqueeze(-4), dim=-3)


def _mtm(A, B):
    """(..., k, n, B)ᵀ @ (..., k, m, B) -> (..., n, m, B)."""
    return torch.sum(A.unsqueeze(-2) * B.unsqueeze(-3), dim=-4)


def _inv3_bl(A):
    """Closed-form inverse of a (3, 3, B) stack (adjugate / det)."""
    a, b, c = A[0, 0], A[0, 1], A[0, 2]
    d, e, f = A[1, 0], A[1, 1], A[1, 2]
    g, h, i = A[2, 0], A[2, 1], A[2, 2]
    A11 = e * i - f * h
    A12 = c * h - b * i
    A13 = b * f - c * e
    A21 = f * g - d * i
    A22 = a * i - c * g
    A23 = c * d - a * f
    A31 = d * h - e * g
    A32 = b * g - a * h
    A33 = a * e - b * d
    det = a * A11 + b * A21 + c * A31
    inv = torch.stack(
        [
            torch.stack([A11, A12, A13]),
            torch.stack([A21, A22, A23]),
            torch.stack([A31, A32, A33]),
        ]
    )
    return inv / det


def _quat_G_bl(q):
    """q (..., 4, B) -> G(q) (..., 4, 3, B)."""
    w, x, y, z = q[..., 0, :], q[..., 1, :], q[..., 2, :], q[..., 3, :]
    rows = [[-x, -y, -z], [w, -z, y], [z, w, -x], [-y, x, w]]
    return torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)


def _half_Rw(w):
    """½·R([0, w]) — right-multiplication matrix of a pure-vector quaternion,
    (..., 3, B) -> (..., 4, 4, B)."""
    wx, wy, wz = w[..., 0, :], w[..., 1, :], w[..., 2, :]
    z = torch.zeros_like(wx)
    rows = [[z, -wx, -wy, -wz], [wx, z, wz, -wy], [wy, -wz, z, wx], [wz, wy, -wx, z]]
    return 0.5 * torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)


def _skew_bl(r):
    """r (3, B|1) -> skew(r) (3, 3, B|1)."""
    rx, ry, rz = r[0], r[1], r[2]
    zz = torch.zeros_like(rx)
    rows = [[zz, -rz, ry], [rz, zz, -rx], [-ry, rx, zz]]
    return torch.stack([torch.stack(row) for row in rows])


def _moment(u, p: SrbParams):
    """Body-frame moment Σ rᵢ × fᵢ + c × (m_c·g_body), (..., 3, B)."""
    n_feet = p.foot_pos.shape[0]
    g_body = -GRAVITY * p.rot_body_to_world[2]  # Rᵀ g_world
    forces = u.unflatten(-2, (n_feet, 3))  # (..., n_feet, 3, B)
    moment = torch.sum(cross(p.foot_pos, forces, dim=-2), dim=-3)
    return moment + cross(p.com_offset, p.com_mass * g_body, dim=-2)


def _force_rows(p: SrbParams):
    """State-independent force rows: Bv = (1/m)[I₃ …] (3, n_u, B|1) and
    Bw = [I⁻¹·skew(rᵢ) …] (3, n_u, B|1)."""
    n_feet = p.foot_pos.shape[0]
    eye3 = _eye(3, p.inertia)
    Bv = (eye3 * (1.0 / p.mass)).repeat(1, n_feet, 1)
    inv_inertia = _inv3_bl(p.inertia)
    Bw = torch.cat(
        [_mm(inv_inertia, _skew_bl(p.foot_pos[i])) for i in range(n_feet)], dim=1
    )
    return Bv, Bw


# ---------------------------------------------------------------------------
# Fleet model functions
# ---------------------------------------------------------------------------


def quat_srb_dynamics_fleet(x: torch.Tensor, u: torch.Tensor, p: SrbParams) -> torch.Tensor:
    """Batch-last quaternion SRB ẋ; x (..., 13, B), u (..., 3·n_feet, B) -> (..., 13, B)."""
    q = x[..., 3:7, :]
    v = x[..., 7:10, :]
    omega = x[..., 10:13, :]
    n_feet = p.foot_pos.shape[0]

    g_body = -GRAVITY * p.rot_body_to_world[2]
    total_force = torch.sum(u.unflatten(-2, (n_feet, 3)), dim=-3)
    moment = _moment(u, p)

    q_dot = 0.5 * torch.sum(_quat_G_bl(q) * omega.unsqueeze(-3), dim=-2)
    v_dot = total_force / p.mass + g_body
    omega_dot = torch.sum(_inv3_bl(p.inertia) * moment.unsqueeze(-3), dim=-2)
    return torch.cat([v, q_dot, v_dot, omega_dot], dim=-2)


def quat_srb_jacobian_fleet(x: torch.Tensor, u: torch.Tensor, p: SrbParams) -> torch.Tensor:
    """Batch-last analytic Jacobian [∂ẋ/∂x, ∂ẋ/∂u], (..., 13, 13+3·n_feet, B)."""
    del u  # the dynamics are affine in u
    q = x[..., 3:7, :]
    omega = x[..., 10:13, :]
    n_u = 3 * p.foot_pos.shape[0]
    Bv, Bw = _force_rows(p)

    J = x.new_zeros(x.shape[:-2] + (13, 13 + n_u, x.shape[-1]))
    J[..., 0:3, 7:10, :] = _eye(3, x)          # ṗ = v
    J[..., 3:7, 3:7, :] = _half_Rw(omega)      # ∂q̇/∂q = ½R([0, ω])
    J[..., 3:7, 10:13, :] = 0.5 * _quat_G_bl(q)  # ∂q̇/∂ω = ½G(q)
    J[..., 7:10, 13:, :] = Bv                  # ∂v̇/∂u
    J[..., 10:13, 13:, :] = Bw                 # ∂ω̇/∂u
    return J


class SrbEdjBlocks(NamedTuple):
    """Block decomposition of the quaternion SRB's error-state discrete
    Jacobians (see `quat_srb_error_discrete_jac_fleet` for the derivation):

        Ae = [[I, 0, h·I, 0],
              [0, A_phi, 0, A_pw],
              [0, 0, I, 0],
              [0, 0, 0, I]]
        Be = [[s_p·(1/m)[I…I]], [B_phi], [s_v·(1/m)[I…I]], [s_w·Bw]]

    `solver.fleet._structured_q_terms` writes the products of the Riccati
    step against this sparsity; K8 (`kernels.expansions`) computes the blocks
    in registers and writes Ae and Be dense."""

    A_phi: torch.Tensor  # (..., 3, 3, B)
    A_pw: torch.Tensor   # (..., 3, 3, B)
    B_phi: torch.Tensor  # (..., 3, nu, B)
    Bw: torch.Tensor     # (3, nu, B|1)
    inv_m: torch.Tensor  # (B|1,)
    h: torch.Tensor      # scalar or (B,)
    s_p: torch.Tensor    # ½h²
    s_v: torch.Tensor    # h
    s_w: torch.Tensor    # h


def quat_srb_edj_blocks(x, x1, u, p: SrbParams, h) -> SrbEdjBlocks:
    """The blocks of the error-state discrete Jacobians under the midpoint
    rule; `quat_srb_error_discrete_jac_fleet` places them."""
    q = x[..., 3:7, :]
    omega = x[..., 10:13, :]

    _, Bw = _force_rows(p)
    inv_inertia = _inv3_bl(p.inertia)
    omega_dot = torch.sum(inv_inertia * _moment(u, p).unsqueeze(-3), dim=-2)
    q_dot = 0.5 * torch.sum(_quat_G_bl(q) * omega.unsqueeze(-3), dim=-2)
    q_m = q + 0.5 * h * q_dot
    w_m = omega + 0.5 * h * omega_dot

    Qq = _half_Rw(omega)
    Qq_m = _half_Rw(w_m)
    Qw = 0.5 * _quat_G_bl(q)
    Qw_m = 0.5 * _quat_G_bl(q_m)
    G0 = _quat_G_bl(q)
    G1 = _quat_G_bl(x1[..., 3:7, :])

    hh = 0.5 * h * h
    D_qq = _eye(4, x) + h * Qq_m + hh * _mm(Qq_m, Qq)
    D_qw = h * Qw_m + hh * _mm(Qq_m, Qw)
    return SrbEdjBlocks(
        A_phi=_mtm(G1, _mm(D_qq, G0)), A_pw=_mtm(G1, D_qw),
        B_phi=_mtm(G1, hh * _mm(Qw_m, Bw)), Bw=Bw, inv_m=1.0 / p.mass, h=h,
        s_p=hh, s_v=h, s_w=h,
    )


def quat_srb_error_discrete_jac_fleet(x, x1, u, p: SrbParams, h):
    """Error-state discrete Jacobians (Ae (..., 12, 12, B), Be (..., 12, n_u, B))
    under midpoint discretization, computed blockwise from the model's
    sparsity (exact algebra; derivation in the JAX counterpart's docstring):

        Ae = [[I₃, 0, h·I₃, 0],
              [0, G₁ᵀ·D_qq·G₀, 0, G₁ᵀ·D_qω],
              [0, 0, I₃, 0],
              [0, 0, 0, I₃]]
        Be = [[½h²·Bv], [G₁ᵀ·(½h²·½G_m·Bω)], [h·Bv], [h·Bω]]

    with D_qq = I₄ + h·½R(ω_m) + ½h²·½R(ω_m)·½R(ω), D_qω = h·½G(q_m) +
    ½h²·½R(ω_m)·½G(q): the blocks of `quat_srb_edj_blocks`, placed."""
    blk = quat_srb_edj_blocks(x, x1, u, p, h)
    n_u = blk.Bw.shape[1]
    eye3 = _eye(3, x)
    Bv = (eye3 * blk.inv_m).repeat(1, n_u // 3, 1)

    lead, B = x.shape[:-2], x.shape[-1]
    Ae = x.new_zeros(lead + (12, 12, B))
    Ae[..., 0:3, 0:3, :] = eye3
    Ae[..., 0:3, 6:9, :] = blk.h * eye3
    Ae[..., 3:6, 3:6, :] = blk.A_phi
    Ae[..., 3:6, 9:12, :] = blk.A_pw
    Ae[..., 6:9, 6:9, :] = eye3
    Ae[..., 9:12, 9:12, :] = eye3

    Be = x.new_zeros(lead + (12, n_u, B))
    Be[..., 0:3, :, :] = blk.s_p * Bv
    Be[..., 3:6, :, :] = blk.B_phi
    Be[..., 6:9, :, :] = blk.s_v * Bv
    Be[..., 9:12, :, :] = blk.s_w * blk.Bw
    return Ae, Be


# ---------------------------------------------------------------------------
# Euler SRB (convex-MPC baseline), batch-last: x (..., 12, B)
# ---------------------------------------------------------------------------


def _rotz_bl(yaw):
    """(..., 3, 3, B) yaw rotation from a (..., B) yaw."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    z = torch.zeros_like(yaw)
    one = torch.ones_like(yaw)
    rows = [[c, -s, z], [s, c, z], [z, z, one]]
    return torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)


def _inv_inertia_world_bl(yaw, inertia):
    """Rz · I⁻¹ · Rzᵀ as a (..., 3, 3, B) stack ((Rz I Rzᵀ)⁻¹); inertia
    (3, 3, B|1)."""
    Rz = _rotz_bl(yaw)
    return _mm(_mm(Rz, _inv3_bl(inertia)), Rz.transpose(-3, -2))


def euler_srb_dynamics_fleet(x: torch.Tensor, u: torch.Tensor, p: SrbParams) -> torch.Tensor:
    """Batch-last Euler SRB ẋ (AltroUtils.cpp:224-293 semantics):
    x = [rpy, p, ω_world, v_world] (..., 12, B), u (..., 3·n_feet, B)."""
    yaw = x[..., 2, :]
    omega = x[..., 6:9, :]
    v = x[..., 9:12, :]
    n_feet = p.foot_pos.shape[0]

    c, s = torch.cos(yaw), torch.sin(yaw)
    # yaw-only ang_vel -> rpy-rate map (AltroUtils.cpp:256-259)
    w0, w1, w2 = omega[..., 0, :], omega[..., 1, :], omega[..., 2, :]
    rpy_rate = torch.stack([c * w0 + s * w1, -s * w0 + c * w1, w2], dim=-2)

    forces = u.unflatten(-2, (n_feet, 3))  # (..., n_feet, 3, B)
    total_force = torch.sum(forces, dim=-3)
    moment = torch.sum(cross(p.foot_pos, forces, dim=-2), dim=-3)
    inv_Iw = _inv_inertia_world_bl(yaw, p.inertia)
    omega_dot = torch.sum(inv_Iw * moment.unsqueeze(-3), dim=-2)

    g = torch.zeros_like(total_force)
    g[..., 2, :] = -GRAVITY
    v_dot = total_force / p.mass + g
    return torch.cat([rpy_rate, v, omega_dot, v_dot], dim=-2)


def euler_srb_jacobian_fleet(x: torch.Tensor, u: torch.Tensor, p: SrbParams) -> torch.Tensor:
    """Batch-last reference-faithful approximate Jacobian (..., 12, 12+n_u, B):
    d(rpy_rate)/dyaw + the constant A/B blocks, d(B·u)/dyaw dropped
    (AltroUtils.cpp:352-359)."""
    del u
    yaw = x[..., 2, :]
    wx, wy = x[..., 6, :], x[..., 7, :]
    n_feet = p.foot_pos.shape[0]
    n_u = 3 * n_feet
    c, s = torch.cos(yaw), torch.sin(yaw)
    zero, one = torch.zeros_like(yaw), torch.ones_like(yaw)

    J = x.new_zeros(x.shape[:-2] + (12, 12 + n_u, x.shape[-1]))
    # rows 0-2: d(rpy_rate)/dyaw at col 2, ang_vel_to_rpy at cols 6-8
    J[..., 0, 2, :] = wy * c - wx * s
    J[..., 1, 2, :] = -wx * c - wy * s
    rows = [[c, s, zero], [-s, c, zero], [zero, zero, one]]
    J[..., 0:3, 6:9, :] = torch.stack([torch.stack(r, dim=-2) for r in rows], dim=-3)
    J[..., 3:6, 9:12, :] = _eye(3, x)  # ṗ = v
    # rows 6-8 (ω̇): I_w⁻¹·skew(r_i) per foot
    inv_Iw = _inv_inertia_world_bl(yaw, p.inertia)
    for i in range(n_feet):
        J[..., 6:9, 12 + 3 * i : 15 + 3 * i, :] = _mm(inv_Iw, _skew_bl(p.foot_pos[i]))
    # rows 9-11 (v̇): I₃/m per foot
    J[..., 9:12, 12:, :] = (_eye(3, x) * (1.0 / p.mass)).repeat(1, n_feet, 1)
    return J


# ---------------------------------------------------------------------------
# The reference's single-problem functions, x (nx,), u (3·n_feet,), unbatched
# params: views of the fleet functions above (`f.fleet`), not second copies.
# ---------------------------------------------------------------------------

quat_srb_dynamics = single_view(quat_srb_dynamics_fleet)
quat_srb_jacobian = single_view(quat_srb_jacobian_fleet)
# the structured error-state discrete Jacobian of the midpoint step, which a
# solver may take in place of discretizing `quat_srb_jacobian`
quat_srb_dynamics.edj = quat_srb_error_discrete_jac_fleet
# the tag of the model in K2 (kernels/line_search.py), whose instantiations
# run the line search of this model under the integrators they name
quat_srb_dynamics.line_search = "quat_srb"
# the tag of the model in K8 (kernels/expansions.py), which computes the knot
# expansions of a spec that carries the structured Jacobian above
quat_srb_dynamics.expansions = "quat_srb"
euler_srb_dynamics = single_view(euler_srb_dynamics_fleet)
euler_srb_dynamics.line_search = "euler_srb"  # midpoint rule and forward Euler
euler_srb_jacobian = single_view(euler_srb_jacobian_fleet)
# K8's tag: its knot expansions of a spec whose Jacobian is euler_srb_jacobian
# (midpoint rule and forward Euler)
euler_srb_dynamics.expansions = "euler_srb"
