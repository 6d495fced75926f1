"""Euler convex-MPC baseline (port of
`quaternion_mpc_tpu/control/convex_mpc.py`; reference ``src/mpc/ConvexMpc.cpp``),
for a fleet (`make_fleet_controller`) and for one robot (`make_controller`).

World-frame Euler SRB with yaw-ramped references (:95-114), plain LQR cost
(:147-151), world-frame friction pyramid (:15-33), and body-frame extraction
of the first input (:188-192). The state is a plain vector (no quaternion),
so the solver runs its generic dense Jacobian path (`fj`, no `edj`).

The reference `vmap`s a single-problem builder; here `build_fleet_problem`
is written batched directly, batch-first in, batch-last out, and the
single-problem `build_problem` is its B = 1.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch.control.quat_mpc import GRAVITY, cone_matrix, single_as_fleet
from quaternion_mpc_tpu_torch.control.types import Command, ControlOutput, RobotFeedback
from quaternion_mpc_tpu_torch.models.srb import (
    SrbParams,
    euler_srb_dynamics,
    euler_srb_dynamics_fleet,
    euler_srb_jacobian,
    euler_srb_jacobian_fleet,
    params_to_fleet,
)
from quaternion_mpc_tpu_torch.ops import lie
from quaternion_mpc_tpu_torch.solver.al_ilqr import lower_problem, make_solver
from quaternion_mpc_tpu_torch.solver.fleet import (
    FleetModelSpec,
    FleetProblem,
    make_fleet_solver,
)
from quaternion_mpc_tpu_torch.solver.problem import ModelSpec, SolverOptions, TrajOptProblem
from quaternion_mpc_tpu_torch.utils import config as cfg_mod


class ConvexMpcWeights(NamedTuple):
    """Numeric controller parameters (a leading batch axis for fleets)."""

    Qd: torch.Tensor          # (12,) [rpy, p, ω, v] order
    Rd: torch.Tensor          # (12,)
    mu: torch.Tensor
    fz_max: torch.Tensor
    mass: torch.Tensor
    inertia: torch.Tensor     # (3,3) trunk inertia (world model rotates by yaw)
    h: torch.Tensor           # seconds


def weights_from_config(
    cfg: cfg_mod.FrameworkConfig, *, dtype: torch.dtype, device=None
) -> ConvexMpcWeights:
    m, r = cfg.mpc, cfg.robot
    t = lambda a: _bridge.tensor(a, device, dtype)
    return ConvexMpcWeights(
        Qd=t(m.q_weights[:12]),
        Rd=t(m.r_weights),
        mu=t(m.mu),
        fz_max=t(m.fz_max),
        mass=t(r.mass),
        inertia=t(np.diag(r.trunk_inertia)),
        h=t(m.update_period_ms / 1000.0),
    )


def build_fleet_problem(fbk, cmd, wts, horizon: int):
    """Batch-first (fbk, cmd, wts) -> batch-last FleetProblem.

    x = [rpy, p_world, ω_world, v_world] (ConvexMpc.cpp:95-114, 156-167).
    ``cmd.contacts`` is (B, n_feet), one schedule tiled over the horizon, or
    (B, N+1, n_feet) per knot.
    """
    quat = fbk.torso_quat
    dtype, device = quat.dtype, quat.device
    nb = quat.shape[0]
    n_feet = fbk.foot_pos_body.shape[-2]
    n_knots = horizon + 1
    zeros = lambda *shape: torch.zeros(shape, dtype=dtype, device=device)
    rot = lie.quat_to_rotmat(quat)    # (B, 3, 3)
    euler = lie.quat_to_euler(quat)   # (B, 3)

    per_knot = cmd.contacts.dim() == 3
    contacts_k = cmd.contacts.expand(nb, n_knots, n_feet) if per_knot else (
        cmd.contacts[:, None, :].expand(nb, n_knots, n_feet)
    )
    num_contacts = torch.clamp(torch.sum(contacts_k, dim=-1, keepdim=True), min=1.0)
    fz_share = contacts_k * wts.mass[:, None, None] * GRAVITY / num_contacts
    u_ref = zeros(nb, n_knots, n_feet, 3)
    u_ref[..., 2] = fz_share
    u_ref = u_ref.reshape(nb, n_knots, 3 * n_feet)

    # yaw-ramped reference; desired world position/velocity from the
    # body-frame command
    steps = torch.arange(n_knots, dtype=dtype, device=device)
    yaw_rate = cmd.ang_vel_body_d[:, 2:3]
    yaw_ref = euler[:, 2:3] + yaw_rate * wts.h[:, None] * steps
    vel_d_world = (lie.rotz(euler[:, 2]) @ cmd.lin_vel_body_d[..., None])[..., 0]
    pos_d_world = fbk.torso_pos_world + (rot @ cmd.pos_body_d[..., None])[..., 0]
    x_ref = zeros(nb, n_knots, 12)
    x_ref[..., 2] = yaw_ref
    x_ref[..., 3:6] = pos_d_world[:, None, :]
    x_ref[..., 8] = yaw_rate
    x_ref[..., 9:11] = vel_d_world[:, None, :2]

    # feet in the "absolute CoM" frame: R · foot_pos_body (BaseInterface.cpp:223)
    params = SrbParams(
        foot_pos=fbk.foot_pos_body @ rot.transpose(-1, -2),
        inertia=wts.inertia,
        mass=wts.mass,
        com_offset=zeros(nb, 3),
        com_mass=zeros(nb),
        rot_body_to_world=rot,
    )

    # world-frame friction pyramid, block diagonal over the legs (no
    # rotation, ConvexMpc.cpp:130-140)
    C = cone_matrix(wts.mu)  # (B, 6, 3)
    Cu = zeros(nb, 6 * n_feet, 3 * n_feet)
    for i in range(n_feet):
        Cu[:, 6 * i : 6 * i + 6, 3 * i : 3 * i + 3] = C
    fz_max = -wts.fz_max
    if per_knot:
        cb = zeros(nb, n_knots, 6 * n_feet)
        cb[:, :, 4::6] = fz_max[:, None, None] * contacts_k
    else:
        cb = zeros(nb, 6 * n_feet)
        cb[:, 4::6] = fz_max[:, None] * cmd.contacts

    omega_world = (rot @ fbk.torso_ang_vel_body[..., None])[..., 0]
    x0 = torch.cat([euler, fbk.torso_pos_world, omega_world, fbk.torso_lin_vel_world], dim=-1)

    bl = lambda a: torch.movedim(a, 0, -1).contiguous()
    return FleetProblem(
        x0=bl(x0),
        x_ref=bl(x_ref),
        u_ref=bl(u_ref),
        Qd=bl(wts.Qd),
        Rd=bl(wts.Rd),
        w=zeros(nb),  # no attitude geodesic term
        Cu=bl(Cu),
        cb=bl(cb),
        h=wts.h,
        params=params_to_fleet(params, batch_axis=True),
        us_init=bl(u_ref[:, :horizon]),
    )


MODEL_SPEC = ModelSpec(
    nx=12, nu=12, f=euler_srb_dynamics, fj=euler_srb_jacobian, quat_idx=None
)


def build_problem(
    fbk: RobotFeedback,
    cmd: Command,
    wts: ConvexMpcWeights,
    horizon: int,
) -> TrajOptProblem:
    """One robot's `TrajOptProblem` (or a batch-first fleet's): B = 1 of
    `build_fleet_problem`."""
    fbk_b, cmd_b, wts_b, batched = single_as_fleet(fbk, cmd, wts)
    return lower_problem(build_fleet_problem(fbk_b, cmd_b, wts_b, horizon), batched)


FLEET_MODEL_SPEC = FleetModelSpec(
    nx=12,
    nu=12,
    f=euler_srb_dynamics_fleet,
    fj=euler_srb_jacobian_fleet,
    quat_idx=None,
    line_search="euler_srb",  # K2 (kernels/line_search.py), its midpoint instantiation
    expansions="euler_srb",  # K8 (kernels/expansions.py): the knot expansions
)


def _fleet_spec() -> FleetModelSpec:
    return FLEET_MODEL_SPEC


def make_fleet_controller(
    horizon: int,
    opts: SolverOptions = SolverOptions(al_iterations=1, ilqr_iterations=5),
    return_body: bool = False,
    return_sol: bool = False,
    backend: str = "auto",
):
    """Batch-last convex grf_update over a whole fleet, the same surface as
    `quat_mpc.make_fleet_controller`: batch-FIRST (fbk, cmd, wts) in,
    (grf_world (B, n_feet, 3)[, grf_body], cost) out, optional batch-first
    warm starts ``us_init`` (B, N, nu) and ``lam_init`` (B, N, nc), and the
    batch-last FleetSolution with return_sol=True. iterations_max=5 online
    (ConvexMpc.cpp:37) is the default 1 AL x 5 iLQR."""
    solver = make_fleet_solver(_fleet_spec(), opts, backend=backend)

    def grf_update(fbk, cmd, wts, us_init=None, lam_init=None):
        prob = build_fleet_problem(fbk, cmd, wts, horizon)
        if us_init is not None:
            prob = prob._replace(us_init=torch.movedim(us_init, 0, -1).contiguous())
        if lam_init is not None:
            prob = prob._replace(lam_init=torch.movedim(lam_init, 0, -1).contiguous())
        sol = solver(prob)
        u0 = torch.movedim(sol.us[0], -1, 0)  # (B, 12) world frame
        grf_world = u0.reshape(u0.shape[0], -1, 3)
        rot = lie.quat_to_rotmat(fbk.torso_quat)  # (B, 3, 3)
        grf_body = torch.einsum("bij,bfi->bfj", rot, grf_world)  # Rᵀ·u per leg
        out = (grf_world, grf_body, sol.cost) if return_body else (grf_world, sol.cost)
        if return_sol:
            return out + (sol,)
        return out

    return grf_update


def make_controller(
    horizon: int,
    opts: SolverOptions = SolverOptions(al_iterations=1, ilqr_iterations=5),
):
    """Returns grf_update(fbk, cmd, wts) -> (ControlOutput, Solution) for
    one robot, or for a fleet with a leading batch axis on every leaf.
    iterations_max=5 online (ConvexMpc.cpp:37)."""
    solver = make_solver(MODEL_SPEC, opts)

    def grf_update(fbk: RobotFeedback, cmd: Command, wts: ConvexMpcWeights):
        sol = solver(build_problem(fbk, cmd, wts, horizon))
        rot = lie.quat_to_rotmat(fbk.torso_quat)
        grf_world = sol.us[..., 0, :].unflatten(-1, (-1, 3))
        out = ControlOutput(
            grf_body=grf_world @ rot,  # Rᵀ·u per leg (ConvexMpc.cpp:190-192)
            grf_world=grf_world,
            foot_pos_target_world=torch.zeros_like(fbk.foot_pos_body),
            foot_vel_target_world=torch.zeros_like(fbk.foot_pos_body),
            mpc_cost=sol.stats.cost,
            mpc_iterations=sol.stats.iterations,
        )
        return out, sol

    return grf_update
