"""Quaternion MPC (port of `quaternion_mpc_tpu/control/quat_mpc.py`): problem
assembly from feedback + command and GRF extraction, for a fleet
(`make_fleet_controller`) and for one robot (`make_controller`).

Semantics mirror ``legged_ctrl/src/mpc/QuatMpc.cpp:109-276`` (grf_update):
body-frame position ramp from the command, constant desired quaternion,
weight-split u_ref over planned contacts (:148-176); inertia = 1.2·I_trunk
(:182) and the feedback attitude frozen into gravity (:184-189); friction
pyramid rotated into the world frame, C·R(q)·u + b ≤ 0 with per-leg fz_max
gating (:47-52, :194-215); x_init body-centric, and the reference's
comma-typo at :242 kept as ``zero_initial_omega`` (default True).

The reference `vmap`s a single-problem builder; here `build_fleet_problem`
is written batched directly, batch-first in, batch-last out, and the
single-problem `build_problem` is its B = 1.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch.control.types import Command, ControlOutput, RobotFeedback
from quaternion_mpc_tpu_torch.models.srb import (
    SrbParams,
    params_to_fleet,
    quat_srb_dynamics,
    quat_srb_dynamics_fleet,
    quat_srb_error_discrete_jac_fleet,
    quat_srb_jacobian,
    quat_srb_jacobian_fleet,
)
from quaternion_mpc_tpu_torch.ops import lie
from quaternion_mpc_tpu_torch.solver.al_ilqr import lower_problem, make_solver
from quaternion_mpc_tpu_torch.solver.fleet import (
    FleetModelSpec,
    FleetProblem,
    make_fleet_solver,
)
from quaternion_mpc_tpu_torch.solver.problem import ModelSpec, SolverOptions, TrajOptProblem
from quaternion_mpc_tpu_torch.utils.tree import tree_map
from quaternion_mpc_tpu_torch.utils import config as cfg_mod

GRAVITY = 9.81

# one leg's friction-pyramid rows (QuatMpc.cpp:47-52):
#   fx−μfz, −fx−μfz, fy−μfz, −fy−μfz, fz−fz_max, −fz  ≤ 0
_CONE = np.array(
    [
        [1.0, 0.0, 0.0],
        [-1.0, 0.0, 0.0],
        [0.0, 1.0, 0.0],
        [0.0, -1.0, 0.0],
        [0.0, 0.0, 1.0],
        [0.0, 0.0, -1.0],
    ]
)
_CONE_MU = np.array([1.0, 1.0, 1.0, 1.0, 0.0, 0.0])


@functools.cache
def _cone_tables(device: torch.device, dtype: torch.dtype):
    """_CONE and _CONE_MU on a device, uploaded once: a tensor built from
    host data on every solve would synchronise with the host."""
    return _bridge.tensor(_CONE, device, dtype), _bridge.tensor(_CONE_MU, device, dtype)


def cone_matrix(mu: torch.Tensor) -> torch.Tensor:
    """Friction-pyramid rows (..., 6, 3) for friction coefficients mu (...,)."""
    cone, cone_mu = _cone_tables(mu.device, mu.dtype)
    C = cone.expand(mu.shape + _CONE.shape).clone()
    C[..., :, 2] = C[..., :, 2] + (-mu[..., None] * cone_mu)
    return C


def cone_matrix_with_normal(mu, normal: torch.Tensor) -> torch.Tensor:
    """Friction-pyramid rows for a contact with surface normal ``normal``
    (..., 3) (the ``spider_dog`` chimney-climb configs: non-flat contact
    normals; flat ground ``normal=ẑ`` reduces to `cone_matrix`).

    Builds a tangent basis (t1, t2) ⊥ n and returns (..., 6, 3) rows
    [±t1 − μn; ±t2 − μn; n; −n] so that C·f + b ≤ 0 encodes
    |f·t| ≤ μ(f·n), 0 ≤ f·n ≤ f_max.
    """
    n = normal / torch.linalg.norm(normal, dim=-1, keepdim=True)
    # tangent basis: pick the world axis least aligned with n
    z_axis = torch.zeros_like(n)
    z_axis[..., 2] = 1.0
    x_axis = torch.zeros_like(n)
    x_axis[..., 0] = 1.0
    ref = torch.where(torch.abs(n[..., 2:3]) < 0.9, z_axis, x_axis)
    t1 = lie.cross(ref, n)
    t1 = t1 / torch.linalg.norm(t1, dim=-1, keepdim=True)
    t2 = lie.cross(n, t1)
    return torch.stack(
        [t1 - mu * n, -t1 - mu * n, t2 - mu * n, -t2 - mu * n, n, -n], dim=-2
    )


class QuatMpcWeights(NamedTuple):
    """Numeric controller parameters (a leading batch axis for fleets)."""

    Qd: torch.Tensor          # (13,)
    Rd: torch.Tensor          # (12,)
    w: torch.Tensor
    mu: torch.Tensor
    fz_max: torch.Tensor
    mass: torch.Tensor
    trunk_mass: torch.Tensor
    inertia: torch.Tensor     # (3,3) MPC model inertia (1.2·I_trunk)
    com_offset: torch.Tensor  # (3,)
    h: torch.Tensor           # seconds


def weights_from_config(
    cfg: cfg_mod.FrameworkConfig, *, dtype: torch.dtype, device=None
) -> QuatMpcWeights:
    m = cfg.mpc
    r = cfg.robot
    t = lambda a: _bridge.tensor(a, device, dtype)
    return QuatMpcWeights(
        Qd=t(m.q_weights),
        Rd=t(m.r_weights),
        w=t(m.w),
        mu=t(m.mu),
        fz_max=t(m.fz_max),
        mass=t(r.mass),
        trunk_mass=t(r.trunk_mass),
        inertia=t(1.2 * np.diag(r.trunk_inertia)),
        com_offset=t(r.com_offset),
        h=t(m.update_period_ms / 1000.0),
    )


def build_fleet_problem(fbk, cmd, wts, horizon: int, zero_initial_omega: bool = True):
    """Batch-first (fbk, cmd, wts) -> batch-last FleetProblem.

    ``cmd.contacts`` is (B, n_feet), one schedule tiled over the horizon (the
    reference behaviour), or (B, N+1, n_feet) per knot.
    """
    quat = fbk.torso_quat
    dtype, device = quat.dtype, quat.device
    nb = quat.shape[0]
    n_feet = fbk.foot_pos_body.shape[-2]
    n_knots = horizon + 1
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    rot = lie.quat_to_rotmat(quat)  # (B, 3, 3)

    # references over the horizon (QuatMpc.cpp:148-176)
    per_knot = cmd.contacts.dim() == 3
    contacts_k = cmd.contacts.expand(nb, n_knots, n_feet) if per_knot else (
        cmd.contacts[:, None, :].expand(nb, n_knots, n_feet)
    )
    num_contacts = torch.clamp(torch.sum(contacts_k, dim=-1, keepdim=True), min=1.0)
    fz_share = contacts_k * wts.mass[:, None, None] * GRAVITY / num_contacts
    u_ref = zeros(nb, n_knots, n_feet, 3)
    u_ref[..., 2] = fz_share
    u_ref = u_ref.reshape(nb, n_knots, 3 * n_feet)

    steps = torch.arange(n_knots, dtype=dtype, device=device)[:, None]
    pos_ref = cmd.pos_body_d[:, None, :] + (
        cmd.lin_vel_body_d[:, None, :] * steps * wts.h[:, None, None]
    )
    pos_ref[..., 2] = cmd.pos_body_d[:, 2:3]
    x_ref = torch.cat(
        [
            pos_ref,
            cmd.quat_d[:, None, :].expand(nb, n_knots, 4),
            cmd.lin_vel_body_d[:, None, :].expand(nb, n_knots, 3),
            zeros(nb, n_knots, 3),  # ω reference (:172 commented out)
        ],
        dim=-1,
    )

    params = SrbParams(
        foot_pos=fbk.foot_pos_body,
        inertia=wts.inertia,
        mass=wts.mass,
        com_offset=wts.com_offset,
        com_mass=wts.trunk_mass,
        rot_body_to_world=rot,
    )

    # friction pyramid in world frame: C·R·u_leg + b ≤ 0 (QuatMpc.cpp:194-215),
    # block diagonal over the legs
    C_world = cone_matrix(wts.mu) @ rot  # (B, 6, 3)
    Cu = zeros(nb, 6 * n_feet, 3 * n_feet)
    for i in range(n_feet):
        Cu[:, 6 * i : 6 * i + 6, 3 * i : 3 * i + 3] = C_world
    fz_max = -wts.fz_max
    if per_knot:
        cb = zeros(nb, n_knots, 6 * n_feet)
        cb[:, :, 4::6] = fz_max[:, None, None] * contacts_k
    else:
        cb = zeros(nb, 6 * n_feet)
        cb[:, 4::6] = fz_max[:, None] * cmd.contacts

    v_body = (rot.transpose(-1, -2) @ fbk.torso_lin_vel_world[..., None])[..., 0]
    omega0 = zeros(nb, 3) if zero_initial_omega else fbk.torso_ang_vel_body
    x0 = torch.cat([zeros(nb, 3), quat, v_body, omega0], dim=-1)

    bl = lambda a: torch.movedim(a, 0, -1).contiguous()
    return FleetProblem(
        x0=bl(x0),
        x_ref=bl(x_ref),
        u_ref=bl(u_ref),
        Qd=bl(wts.Qd),
        Rd=bl(wts.Rd),
        w=wts.w,
        Cu=bl(Cu),
        cb=bl(cb),
        h=wts.h,
        params=params_to_fleet(params, batch_axis=True),
        us_init=bl(u_ref[:, :horizon]),
    )


MODEL_SPEC = ModelSpec(
    nx=13, nu=12, f=quat_srb_dynamics, fj=quat_srb_jacobian, quat_idx=3
)


def single_as_fleet(fbk, cmd, wts):
    """(fbk, cmd, wts, batched): one robot's unbatched tuples gain a leading
    batch axis of 1; a fleet's pass through."""
    batched = fbk.torso_quat.dim() == 2
    if batched:
        return fbk, cmd, wts, True
    lead = lambda tree: tree_map(lambda a: a[None], tree)
    return lead(fbk), lead(cmd), lead(wts), False


def build_problem(
    fbk: RobotFeedback,
    cmd: Command,
    wts: QuatMpcWeights,
    horizon: int,
    zero_initial_omega: bool = True,
) -> TrajOptProblem:
    """One robot's `TrajOptProblem` (or a batch-first fleet's): B = 1 of
    `build_fleet_problem`."""
    fbk_b, cmd_b, wts_b, batched = single_as_fleet(fbk, cmd, wts)
    return lower_problem(
        build_fleet_problem(fbk_b, cmd_b, wts_b, horizon, zero_initial_omega), batched
    )


FLEET_MODEL_SPEC = FleetModelSpec(
    nx=13,
    nu=12,
    f=quat_srb_dynamics_fleet,
    fj=quat_srb_jacobian_fleet,
    quat_idx=3,
    edj=quat_srb_error_discrete_jac_fleet,
    line_search="quat_srb",  # K2 (kernels/line_search.py), its midpoint instantiation
    # edj_blocks (the block-sparse Q-terms) is not wired in the reference
    # either (quat_mpc.py:246-252); it is the blueprint for the in-kernel
    # expansions of a later K1.
)


def _fleet_spec() -> FleetModelSpec:
    return FLEET_MODEL_SPEC


def make_fleet_controller(
    horizon: int,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=5),
    zero_initial_omega: bool = True,
    return_body: bool = False,
    backend: str = "auto",
    return_sol: bool = False,
):
    """Batch-last grf_update over a whole fleet at once.

    Takes batch-FIRST (fbk, cmd, wts), returns (grf_world (B, n_feet, 3),
    cost (B,)); with return_body=True (grf_world, grf_body, cost); with
    return_sol=True additionally the batch-last FleetSolution. Optional
    batch-first warm starts: ``us_init`` (B, N, nu), ``lam_init`` (B, N, nc).
    ``backend`` picks the backward pass (`solver.fleet.make_fleet_solver`):
    "auto" runs the associative scan for one robot, the sweep for a fleet.
    """
    solver = make_fleet_solver(_fleet_spec(), opts, backend=backend)

    def grf_update(fbk, cmd, wts, us_init=None, lam_init=None):
        prob = build_fleet_problem(fbk, cmd, wts, horizon, zero_initial_omega)
        if us_init is not None:
            prob = prob._replace(us_init=torch.movedim(us_init, 0, -1).contiguous())
        if lam_init is not None:
            prob = prob._replace(lam_init=torch.movedim(lam_init, 0, -1).contiguous())
        sol = solver(prob)
        u0 = torch.movedim(sol.us[0], -1, 0)  # (B, 12)
        grf_body = u0.reshape(u0.shape[0], -1, 3)
        rot = lie.quat_to_rotmat(fbk.torso_quat)  # (B, 3, 3)
        grf_world = torch.einsum("bij,bfj->bfi", rot, grf_body)
        out = (grf_world, grf_body, sol.cost) if return_body else (grf_world, sol.cost)
        if return_sol:
            return out + (sol,)
        return out

    return grf_update


def make_controller(
    horizon: int,
    opts: SolverOptions = SolverOptions(al_iterations=2, ilqr_iterations=5),
    zero_initial_omega: bool = True,
):
    """Returns grf_update(fbk, cmd, wts[, us_init, lam_init]) ->
    (ControlOutput, Solution) for one robot, or for a fleet with a leading
    batch axis on every leaf (what `jax.vmap(ctrl)` takes in the reference).

    Solver budget default mirrors the online config (iterations_max=10 at
    QuatMpc.cpp:22, here 2 AL × 5 iLQR). ``us_init``: optional (N, 12) input
    warm start, the previous tick's ``sol.us`` for the reference's cross-tick
    warm starting (SetState/SetInput, QuatMpc.cpp:250-253); ``lam_init``
    (N+1, nc) the dual one.
    """
    solver = make_solver(MODEL_SPEC, opts)

    def grf_update(fbk: RobotFeedback, cmd: Command, wts: QuatMpcWeights,
                   us_init=None, lam_init=None):
        prob = build_problem(fbk, cmd, wts, horizon, zero_initial_omega)
        if us_init is not None:
            prob = prob._replace(us_init=us_init)
        if lam_init is not None:
            prob = prob._replace(lam_init=lam_init)
        sol = solver(prob)
        rot = lie.quat_to_rotmat(fbk.torso_quat)
        grf_body = sol.us[..., 0, :].unflatten(-1, (-1, 3))
        out = ControlOutput(
            grf_body=grf_body,
            grf_world=grf_body @ rot.transpose(-1, -2),
            foot_pos_target_world=torch.zeros_like(fbk.foot_pos_body),
            foot_vel_target_world=torch.zeros_like(fbk.foot_pos_body),
            mpc_cost=sol.stats.cost,
            mpc_iterations=sol.stats.iterations,
        )
        return out, sol

    return grf_update
