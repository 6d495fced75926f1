"""Named scenarios: the reference's branch configs as data (port of
`quaternion_mpc_tpu/scenarios.py`).

`README.md:20-25` of the reference documents four branches: `main` (Go1
walking), `falling_cat` (airborne attitude reorientation), `spider_dog`
(chimney climb between two walls), `humanoid` (MIT-humanoid biped balance).
The three others differ from `main` only in contact geometry, schedule and
references, so each is a function returning *data*: (ModelSpec,
TrajOptProblem, SolverOptions) for the shared quaternion solver core.

Each of them takes ``dtype`` and ``device`` (None: the port's default, the
card). The receding-horizon step takes one scenario or, with a leading batch
axis on its carry, a fleet of it in one call.
"""

from __future__ import annotations

import numpy as np
import torch

from quaternion_mpc_tpu_torch import _bridge
from quaternion_mpc_tpu_torch.control.quat_mpc import cone_matrix, cone_matrix_with_normal
from quaternion_mpc_tpu_torch.models import attitude, params_to_fleet, srb
from quaternion_mpc_tpu_torch.ops import lie
from quaternion_mpc_tpu_torch.solver.al_ilqr import (
    batch_first,
    batch_last,
    broadcast_problem,
    make_solver,
)
from quaternion_mpc_tpu_torch.solver.problem import (
    CostSpec,
    ModelSpec,
    SolverOptions,
    TrajOptProblem,
)
from quaternion_mpc_tpu_torch.utils.graphs import Graphed

GRAVITY = 9.81


def _np_euler_to_quat(rpy):
    r, p, y = (0.5 * a for a in rpy)
    cr, sr, cp, sp, cy, sy = np.cos(r), np.sin(r), np.cos(p), np.sin(p), np.cos(y), np.sin(y)
    return np.array([
        cy * cp * cr + sy * sp * sr,
        cy * cp * sr - sy * sp * cr,
        cy * sp * cr + sy * cp * sr,
        sy * cp * cr - cy * sp * sr,
    ])


def falling_cat(angle_deg: float = 160.0, N: int = 40, h: float = 0.02, *,
                dtype: torch.dtype, device=None):
    """Contact-free large-angle reorientation under torque limits — the
    singularity-free selling point of the quaternion formulation."""
    t = lambda a: _bridge.tensor(a, device, dtype)
    spec = ModelSpec(
        nx=7, nu=3, f=attitude.attitude_dynamics, quat_idx=0, integrator="midpoint"
    )
    params = attitude.go1_attitude_params(dtype=dtype, device=device)
    axis = np.array([1.0, 0.5, 0.2])
    axis = axis / np.linalg.norm(axis)
    ang = np.deg2rad(angle_deg)
    x0 = np.concatenate([[np.cos(ang / 2)], np.sin(ang / 2) * axis, np.zeros(3)])
    x_goal = np.array([1.0, 0, 0, 0, 0, 0, 0.0])
    Cu, cb = attitude.torque_box(8.0, dtype=dtype, device=device)
    w = np.full((N + 1,), 50.0)
    w[-1] = 10000.0
    prob = TrajOptProblem(
        x0=t(x0),
        cost=CostSpec(
            Qd=t([0.0, 0, 0, 0, 1.0, 1.0, 1.0]),
            Rd=t(1e-3 * np.ones(3)),
            w=t(w),
            x_ref=t(np.tile(x_goal, (N + 1, 1))),
            u_ref=t(np.zeros((N + 1, 3))),
            Qdf=t([0.0, 0, 0, 0, 10.0, 10.0, 10.0]),
        ),
        Cu=Cu, cb=cb, h=t(h), params=params,
        us_init=t(np.zeros((N, 3))),
    )
    return spec, prob, SolverOptions(al_iterations=3, ilqr_iterations=25)


def humanoid(N: int = 20, h: float = 0.02, *, dtype: torch.dtype, device=None):
    """Biped balance: the same quat SRB with 2 contact feet (MIT humanoid)."""
    t = lambda a: _bridge.tensor(a, device, dtype)
    mass = 24.0
    foot_pos = [[0.0, 0.12, -0.8], [0.0, -0.12, -0.8]]
    params = srb.go1_params(
        foot_pos=foot_pos, inertia_scale=1.0, mass=mass, dtype=dtype, device=device
    )
    params = params._replace(
        inertia=t(np.diag([0.3, 0.25, 0.1])), com_offset=t(np.zeros(3)), com_mass=t(0.0)
    )
    spec = ModelSpec(
        nx=13, nu=6, f=srb.quat_srb_dynamics, fj=srb.quat_srb_jacobian, quat_idx=3
    )
    C1 = cone_matrix(t(0.6))
    Cu = torch.block_diag(C1, C1)
    cb = np.zeros((12,))
    cb[4::6] = -400.0
    q0 = _np_euler_to_quat(np.array([0.1, -0.08, 0.0]))
    x0 = np.concatenate([np.zeros(3), q0, [0.1, 0.0, 0.0], np.zeros(3)])
    u_ref = np.tile(np.array([0.0, 0, mass * GRAVITY / 2] * 2), (N + 1, 1))
    prob = TrajOptProblem(
        x0=t(x0),
        cost=CostSpec(
            Qd=t([2.5, 2.5, 10, 0, 0, 0, 0, 0.5, 0.5, 0.5, 0.2, 0.2, 0.2]),
            Rd=t(1e-6 * np.ones(6)),
            w=t(50.0),
            x_ref=t(np.tile(np.array([0.0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0.0]), (N + 1, 1))),
            u_ref=t(u_ref),
        ),
        Cu=Cu, cb=t(cb), h=t(h), params=params, us_init=t(u_ref[:N]),
    )
    return spec, prob, SolverOptions()


def spider_dog(N: int = 15, h: float = 0.02, *, dtype: torch.dtype, device=None):
    """Chimney brace: 4 feet on opposing walls, weight carried entirely by
    friction (rotated cone normals ∓ŷ)."""
    t = lambda a: _bridge.tensor(a, device, dtype)
    mu, mass = 0.7, 12.84
    foot_pos = [[0.2, 0.2, -0.1], [0.2, -0.2, -0.1], [-0.2, 0.2, -0.1], [-0.2, -0.2, -0.1]]
    normals = t([[0.0, -1.0, 0], [0.0, 1.0, 0], [0.0, -1.0, 0], [0.0, 1.0, 0.0]])
    params = srb.go1_params(
        foot_pos=foot_pos, inertia_scale=1.0, mass=mass, dtype=dtype, device=device
    )
    params = params._replace(com_offset=t(np.zeros(3)), com_mass=t(0.0))
    spec = ModelSpec(
        nx=13, nu=12, f=srb.quat_srb_dynamics, fj=srb.quat_srb_jacobian, quat_idx=3
    )
    Cu = torch.block_diag(*cone_matrix_with_normal(mu, normals))
    cb = np.zeros((24,))
    cb[4::6] = -200.0
    press = 60.0
    u0 = np.array(
        [[0.0, -press, mass * GRAVITY / 4], [0.0, press, mass * GRAVITY / 4],
         [0.0, -press, mass * GRAVITY / 4], [0.0, press, mass * GRAVITY / 4]]
    ).reshape(-1)
    x_hover = np.array([0.0, 0, 0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0.0])
    prob = TrajOptProblem(
        x0=t(x_hover),
        cost=CostSpec(
            Qd=t([2.5, 2.5, 10, 0, 0, 0, 0, 1.0, 1.0, 1.0, 0.5, 0.5, 0.5]),
            Rd=t(1e-5 * np.ones(12)),
            w=t(50.0),
            x_ref=t(np.tile(x_hover, (N + 1, 1))),
            u_ref=t(np.tile(u0, (N + 1, 1))),
        ),
        Cu=Cu, cb=t(cb), h=t(h), params=params,
        us_init=t(np.tile(u0, (N, 1))),
    )
    return spec, prob, SolverOptions()


SCENARIOS = {
    "falling_cat": falling_cat,
    "humanoid": humanoid,
    "spider_dog": spider_dog,
}


# solve_scenario's solves, one `Graphed` for each scenario, its arguments
# and the device: a later call with the same ones replays the graph the first
# captured, whose warm-ups and capture cost about three eager solves
_SOLVES = {}


def solve_scenario(name: str, **kwargs):
    """Build + solve a named branch scenario; returns (solution, summary).
    On the card the solve is a CUDA graph (the JAX package jits it), kept
    for later calls with the same name and arguments (`_SOLVES`)."""
    spec, prob, opts = SCENARIOS[name](**kwargs)
    key = (name, _bridge.resolve_device(kwargs.get("device")), *sorted(kwargs.items()))
    if key not in _SOLVES:
        _SOLVES[key] = Graphed(make_solver(spec, opts), label=f"solve_scenario {name}")
    sol = _SOLVES[key](prob)
    qi = spec.quat_idx
    q_end = sol.xs[-1, qi : qi + 4]
    q_ref = prob.cost.x_ref[-1, qi : qi + 4]
    summary = {
        "final_cost": float(sol.stats.cost),
        "constraint_violation": float(sol.stats.constraint_violation),
        "attitude_error": float(1.0 - torch.abs(torch.sum(q_end * q_ref))),
        "max_input": float(torch.max(torch.abs(sol.us))),
    }
    return sol, summary


# ---------------------------------------------------------------------------
# Closed-loop (receding-horizon) tiers — the reference branches were
# closed-loop CONTROLLERS (README.md:20-25), not single trajectory solves.
# ---------------------------------------------------------------------------


def make_receding_step(name: str, opts: SolverOptions = None, **scenario_kw):
    """Receding-horizon closed loop for a branch scenario.

    Re-solves the scenario's trajectory problem FROM THE CURRENT PLANT
    STATE every tick (primal warm start shifted one knot, the RTI scheme of
    the online Go1 controller) and applies u(0) to the scenario's plant:

    - falling_cat: the airborne attitude plant (quat + body rates, full
      gyroscopic term);
    - humanoid / spider_dog: the full SRB plant (`sim.plant`: world-frame
      integration WITH the gyroscopic term the MPC model drops, so the
      loop sees genuine model mismatch) with the scenario's contact feet;
      disturbances inject through `sim.plant.ExtWrench`.

    Returns (step, carry0) where step(carry, ext_wrench=None) ->
    (carry, metrics_dict); carry = (x (nx,), us_warm (N, nu)), or a fleet of
    the scenario with a leading batch axis on both (and on the metrics). A
    tick does not return to the host.
    """
    from quaternion_mpc_tpu_torch.sim import plant as plant_mod

    # the scenario's own opts are the OFFLINE budget; the receding loop
    # uses a per-tick budget (below) since warm starts carry convergence
    spec, prob0, _offline_opts = SCENARIOS[name](**scenario_kw)
    if opts is None:
        opts = SolverOptions(
            al_iterations=2,
            ilqr_iterations=8 if name == "falling_cat" else 4,
        )
    solver = make_solver(spec, opts)
    qi = spec.quat_idx
    h = prob0.h
    q_ref_end = prob0.cost.x_ref[-1, qi : qi + 4]

    if name == "falling_cat":
        params_bl = params_to_fleet(prob0.params)

        def plant_step(x, u, ext):
            batched = x.dim() == 2
            tau = u if ext is None else u + ext.torque_body
            tau_bl = batch_last(tau, batched)

            def f(xx):
                return attitude.attitude_dynamics_fleet(xx, tau_bl, params_bl)

            x_bl = batch_last(x, batched)
            xm = x_bl + 0.5 * h * f(x_bl)
            x_new = batch_first(x_bl + h * f(xm), batched)
            return torch.cat([lie.quat_normalize(x_new[..., 0:4]), x_new[..., 4:]], dim=-1)
    else:
        zero = torch.zeros_like(prob0.params.mass)
        pp = plant_mod.PlantParams(
            mass=prob0.params.mass,
            inertia=prob0.params.inertia,
            com_offset=torch.zeros_like(prob0.params.com_offset),
            com_mass=zero,
            foot_pos_body=prob0.params.foot_pos,
        )

        def plant_step(x, u, ext):
            ps = plant_mod.PlantState(
                pos=x[..., 0:3], quat=x[..., 3:7], vel=x[..., 7:10], omega=x[..., 10:13]
            )
            ps = plant_mod.step(ps, u.unflatten(-1, (-1, 3)), pp, h, ext)
            return torch.cat([ps.pos, ps.quat, ps.vel, ps.omega], dim=-1)

    def step(carry, ext_wrench=None):
        x, us_warm = carry
        base = broadcast_problem(prob0, x.shape[0]) if x.dim() == 2 else prob0
        sol = solver(base._replace(x0=x, us_init=us_warm))
        u0 = sol.us[..., 0, :]
        x_new = plant_step(x, u0, ext_wrench)
        us_next = torch.cat([sol.us[..., 1:, :], sol.us[..., -1:, :]], dim=-2)
        q = x_new[..., qi : qi + 4]
        metrics = {
            "att_err": 1.0 - torch.abs(torch.sum(q * q_ref_end, dim=-1)),
            "cost": sol.stats.cost,
            "u_max": torch.amax(torch.abs(u0), dim=-1),
            "omega_max": torch.amax(torch.abs(x_new[..., -3:]), dim=-1),
        }
        return (x_new, us_next), metrics

    carry0 = (prob0.x0, prob0.us_init)
    return step, carry0


def run_closed_loop(name: str, n_ticks: int = 100, opts: SolverOptions = None,
                    **scenario_kw):
    """Drive a branch scenario's receding-horizon loop; returns a summary.
    On the card the tick is a CUDA graph (the JAX loop jits it), replayed
    each tick with the carry chained in the graph's own buffers; the host
    reads ``u_max`` after each, as the JAX loop does."""
    step, carry = make_receding_step(name, opts=opts, **scenario_kw)
    tick = Graphed(step, chain=True, label=f"run_closed_loop {name}")
    u_hi = 0.0
    m = None
    for _ in range(max(1, n_ticks)):
        carry, m = tick(carry)
        u_hi = max(u_hi, float(m["u_max"]))
    return {
        "final_att_err": float(m["att_err"]),
        "final_omega_max": float(m["omega_max"]),
        "max_input": u_hi,
        "ticks": n_ticks,
    }
