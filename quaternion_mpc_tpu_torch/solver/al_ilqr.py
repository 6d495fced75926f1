"""Single-problem AL-iLQR (port of `quaternion_mpc_tpu/solver/al_ilqr.py`):
`make_solver(spec, opts)` over a `TrajOptProblem`.

The port has one solver core, the batch-last fleet solver (`solver.fleet`).
The reference's two solvers are one algorithm (its own tests hold the fleet
solver to the single one, and the fleet's parallel line-search alphas accept
exactly what serial backtracking accepts), so `make_solver` lifts the
problem to a `FleetProblem` (an unbatched problem is a fleet of one; a
leading batch axis on every leaf, what `jax.vmap(solver)` takes in the
reference, becomes the last), solves it with the sweep backend, the
recursion `al_ilqr` itself runs (regularising Quu; the associative scan
regularises luu and would not match it), and lowers the result to a
`Solution`. Every solve therefore runs the K1 kernel on the card
(`kernels.riccati_sweep`), which takes the cross term lux of a problem with
state rows Cx as well.

Math summary (error state e ∈ R^ne, E(x) = blkdiag(I, G(q), I)):
  A_k = E(x̄_{k+1})ᵀ ∂f_d/∂x E(x̄_k),   B_k = E(x̄_{k+1})ᵀ ∂f_d/∂u
  stage cost expansion at x̄:  l_x = E(x̄)ᵀ g,  l_xx = E(x̄)ᵀ ∇²J E(x̄) + c·I_φ
  with the chart-curvature correction c = −qᵀ(∂J/∂q) on the attitude block.
  AL inequality terms (c = Cx·x + Cu·u + cb ≤ 0, multipliers λ ≥ 0, penalty ρ):
    J_AL += (‖max(0, λ+ρc)‖² − ‖λ‖²)/(2ρ);   λ⁺ = max(0, λ + ρc).
"""

from __future__ import annotations

import torch

from quaternion_mpc_tpu_torch.kernels import expansions as _k8
from quaternion_mpc_tpu_torch.kernels import line_search as _k2
from quaternion_mpc_tpu_torch.models import fleet_form, params_to_fleet
from quaternion_mpc_tpu_torch.solver.fleet import (
    FleetModelSpec,
    FleetProblem,
    make_fleet_solver,
)
from quaternion_mpc_tpu_torch.utils.tree import tree_map
from quaternion_mpc_tpu_torch.solver.problem import (
    CostSpec,
    ModelSpec,
    Solution,
    SolveStats,
    SolverOptions,
    TrajOptProblem,
)


def fleet_spec(spec: ModelSpec) -> FleetModelSpec:
    """The batch-last spec behind a `ModelSpec` of single views. A model
    that carries a structured error-state Jacobian of its midpoint step
    (``f.edj``, the quaternion SRB) keeps it, as its fleet controller does,
    and a model tagged for K2 (``f.line_search``: the quaternion SRB, the
    Euler SRB, the attitude model) keeps its tag where K2 has an
    instantiation for the spec's integrator (`kernels.line_search.
    instantiation`); a model tagged for K8 (``f.expansions``: the quaternion
    SRB, the Euler SRB, the attitude model) keeps that tag where K8 has an
    instantiation for the spec's integrator and the spec asks for the
    Jacobian K8 computes (`kernels.expansions.jacobian_is_the_models`: the
    quaternion SRB's structured one, `euler_srb_jacobian`, the attitude
    model's derivative by autodiff)."""
    midpoint = spec.integrator == "midpoint"
    structured = midpoint and spec.fj is not None
    edj = getattr(spec.f, "edj", None) if structured else None
    tag = getattr(spec.f, "line_search", None)
    k8 = getattr(spec.f, "expansions", None)
    if not (_k8.instantiation(k8, spec.integrator)
            and _k8.jacobian_is_the_models(k8, spec.fj, edj)):
        k8 = None
    return FleetModelSpec(
        nx=spec.nx,
        nu=spec.nu,
        f=fleet_form(spec.f),
        fj=None if spec.fj is None else fleet_form(spec.fj),
        quat_idx=spec.quat_idx,
        edj=edj,
        integrator=spec.integrator,
        line_search=tag if _k2.instantiation(tag, spec.integrator) else None,
        expansions=k8,
    )


def is_batched(prob: TrajOptProblem) -> bool:
    """Whether the problem's leaves carry a leading scenario batch axis."""
    return prob.x0.dim() == 2


def broadcast_problem(prob: TrajOptProblem, batch: int) -> TrajOptProblem:
    """An unbatched problem as a fleet of ``batch`` copies: every leaf gains
    a leading batch axis as a view (replace the leaves that differ)."""
    return tree_map(lambda a: a.expand((batch,) + tuple(a.shape)), prob)


def batch_last(a, batched: bool):
    """A leaf with the batch axis last: moved there, or a new axis of 1."""
    if a is None:
        return None
    return torch.movedim(a, 0, -1) if batched else a[..., None]


def batch_first(a, batched: bool):
    """A batch-last tensor in the caller's layout: batch first, or none."""
    return torch.movedim(a, -1, 0) if batched else a[..., 0]


def lift_problem(prob: TrajOptProblem) -> FleetProblem:
    """`TrajOptProblem` (unbatched, or batch-first on every leaf) -> batch-last
    `FleetProblem`. Without state rows the terminal row of a (N+1, nc)
    ``lam_init`` is dropped: nothing reads it."""
    batched = is_batched(prob)
    cost = prob.cost
    N = prob.us_init.shape[-2]
    bl = lambda a: batch_last(a, batched)
    lam_init = bl(prob.lam_init)
    if lam_init is not None and prob.Cx is None:
        lam_init = lam_init[:N]
    # a scalar weight is (B,) or (1,); a per-knot one (N+1, B) or (N+1, 1)
    if batched:
        w = bl(cost.w)
    else:
        w = cost.w[:, None] if cost.w.dim() == 1 else cost.w.reshape(1)
    return FleetProblem(
        x0=bl(prob.x0),
        x_ref=bl(cost.x_ref),
        u_ref=bl(cost.u_ref),
        Qd=bl(cost.Qd),
        Rd=bl(cost.Rd),
        w=w,
        Cu=bl(prob.Cu),
        cb=bl(prob.cb),
        h=prob.h,
        params=params_to_fleet(prob.params, batched),
        us_init=bl(prob.us_init),
        lam_init=lam_init,
        Qdf=bl(cost.Qdf),
        Cx=bl(prob.Cx),
    )


def lower_problem(fprob: FleetProblem, batched: bool) -> TrajOptProblem:
    """The inverse of `lift_problem` for a problem built batch-last with a
    real batch axis on every leaf (`build_fleet_problem` of a controller): batch first,
    or the one scenario of B = 1."""
    bf = lambda a: None if a is None else batch_first(a, batched)
    return TrajOptProblem(
        x0=bf(fprob.x0),
        cost=CostSpec(
            Qd=bf(fprob.Qd), Rd=bf(fprob.Rd), w=bf(fprob.w),
            x_ref=bf(fprob.x_ref), u_ref=bf(fprob.u_ref), Qdf=bf(fprob.Qdf),
        ),
        Cu=bf(fprob.Cu),
        cb=bf(fprob.cb),
        h=fprob.h if batched else fprob.h.reshape(()),
        params=tree_map(bf, fprob.params),
        us_init=bf(fprob.us_init),
        Cx=bf(fprob.Cx),
        lam_init=bf(fprob.lam_init),
    )


def make_solver(spec: ModelSpec, opts: SolverOptions = SolverOptions()):
    """Build a single-problem solver: solve(prob: TrajOptProblem) -> Solution.
    It takes a fleet as well: every leaf of ``prob`` with a leading batch
    axis, the leaves of the `Solution` likewise."""
    fspec = fleet_spec(spec)
    fleet_solve = make_fleet_solver(fspec, opts, backend="sweep", stats=True)

    def solve_fn(prob: TrajOptProblem) -> Solution:
        batched = is_batched(prob)
        sol = fleet_solve(lift_problem(prob))
        lam = sol.lam
        if prob.Cx is None:
            # the reference carries a terminal multiplier row that only state
            # rows use: zero, or what the warm start held there
            N = prob.us_init.shape[-2]
            tail = (
                torch.zeros_like(lam[:1]) if prob.lam_init is None
                else batch_last(prob.lam_init, batched)[N:]
            )
            lam = torch.cat([lam, tail])
        bf = lambda a: batch_first(a, batched)
        stats = SolveStats(
            cost=bf(sol.cost),
            constraint_violation=bf(sol.constraint_violation),
            grad_norm=bf(sol.grad_norm),
            iterations=bf(sol.active_iterations),
        )
        return Solution(xs=bf(sol.xs), us=bf(sol.us), stats=stats, lam=bf(lam))

    return solve_fn


def solve(spec: ModelSpec, prob: TrajOptProblem, opts: SolverOptions = SolverOptions()):
    """Convenience one-shot solve."""
    return make_solver(spec, opts)(prob)
