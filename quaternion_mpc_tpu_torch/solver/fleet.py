"""Fleet-native AL-iLQR (port of `quaternion_mpc_tpu/solver/fleet.py`): the
same algorithm, every array with the scenario batch as its LAST axis.

    xs (N+1, nx, B)   us (N, nu, B)   As (N, ne, ne, B)   Ks (N, nu, ne, B)

On the GPU batch-last puts neighbouring scenarios on neighbouring addresses,
so the sweep kernel's threads (one per scenario) read coalesced memory.

Functions take any LEADING axes in front of the (state, B) dims and
broadcast them: the knot expansions run once over all N knots (leading N),
and the line search's alphas — a `jax.vmap` in the reference — are one
leading K axis through `rollout` and `total_cost`.

A problem may also carry a terminal weight `Qdf`, a per-knot geodesic weight
`w`, state rows `Cx` of its inequality and a model stepped by forward Euler:
what the single-problem interface (`solver.al_ilqr`) needs of this solver.
A problem that names none of them runs the code it ran without them.

The backward pass is the expansions (`knot_expansions` + `terminal_expansion`,
or for a spec tagged ``expansions`` with a model K8 has an instantiation of,
"quat_srb", "euler_srb" or "attitude", the K8 CUDA kernel
`kernels.expansions`, which computes both in one launch) + either the
K1 CUDA sweep (`kernels.riccati_sweep`, the structure of the reference's
Pallas backend, experiments/pallas_fleet.py riccati_backward_pallas) or the
horizon-parallel associative scan (`solver.parallel_riccati`, whose scan is
the K4 CUDA kernel `kernels.assoc_scan`). The line search (`line_search`:
the rollouts over every alpha, their AL costs, the Armijo test and the
select) is the K2 CUDA kernel `kernels.line_search` for a spec tagged with
a model K2 has an instantiation of (``line_search`` "quat_srb", "euler_srb"
or "attitude") and plain PyTorch for every other. For such a spec, on a
problem without state rows Cx, the solve's open-loop rollout, its
multiplier updates and its final cost are the K9 CUDA kernel
`kernels.rollout` (its `rollout` and `price` entries); plain PyTorch
(`open_loop_rollout`, `constraint_values`, `total_cost`) for every other.
Everything else is plain PyTorch.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import torch
from torch.profiler import record_function

# Module imports (not names): the kernel modules import this module too.
from quaternion_mpc_tpu_torch.kernels import expansions as _k8
from quaternion_mpc_tpu_torch.kernels import line_search as _k2
from quaternion_mpc_tpu_torch.kernels import riccati_sweep as _k1
from quaternion_mpc_tpu_torch.kernels import rollout as _k9
from quaternion_mpc_tpu_torch.models.discretize import (
    error_projection_bl as _error_proj_bl,
    fleet_discrete_jac as _fleet_discrete_jac,
    fleet_step as _fleet_step,
    state_diff_bl as _state_diff_bl,
)
from quaternion_mpc_tpu_torch.models.srb import _eye, _quat_G_bl
from quaternion_mpc_tpu_torch.solver.problem import SolverOptions

# The profiler ranges around a backward pass's expansions, around a solve's
# open-loop rollout, and around each pricing of a solve's trajectory (the
# multiplier update after an AL iteration, the final cost).
EXPANSIONS = "expansions"
OPEN_LOOP = "open_loop_rollout"
PRICING = "pricing"

# ---------------------------------------------------------------------------
# Batch-last tiny linear algebra (broadcast-multiply + sum, full precision)
# ---------------------------------------------------------------------------


def bmm(A, B):
    """(..., n, k, B) @ (..., k, m, B) -> (..., n, m, B)."""
    return torch.sum(A.unsqueeze(-2) * B.unsqueeze(-4), dim=-3)


def bmv(A, x):
    """(..., n, k, B) @ (..., k, B) -> (..., n, B)."""
    return torch.sum(A * x.unsqueeze(-3), dim=-2)


def bt(A):
    """Transpose the matrix dims of (..., n, m, B)."""
    return A.transpose(-3, -2)


def solve_spd_multi(A, rhs_list):
    """Solve A·X = RHS for an SPD (..., n, n, B) stack against several RHS at
    once by Gauss-Jordan elimination on the augmented system, columns in
    order 0..n-1, no pivoting (callers pass a regularised SPD matrix).

    rhs_list: (..., n, B) or (..., n, m, B) tensors with A's leading axes;
    solutions come back in the same shapes. The CUDA kernels eliminate in
    the same order."""
    n = A.shape[-3]
    cols, widths = [A], []
    for r in rhs_list:
        vec = r.dim() == A.dim() - 1
        cols.append(r.unsqueeze(-2) if vec else r)
        widths.append((1 if vec else r.shape[-2], vec))
    M = torch.cat(cols, dim=-2)  # (..., n, n_aug, B)
    for j in range(n):
        row_j = M[..., j, :, :] / M[..., j, j : j + 1, :]
        M = M - M[..., :, j : j + 1, :] * row_j.unsqueeze(-3)
        M[..., j, :, :] = row_j
    out, ofs = [], n
    for width, vec in widths:
        sol = M[..., ofs : ofs + width, :]
        out.append(sol[..., 0, :] if vec else sol)
        ofs += width
    return out


def solve_spd_leading(A, rhs):
    """`solve_spd_multi` for batch-LEADING operands: A (..., n, n) SPD and
    rhs (..., n, m) -> A⁻¹·rhs (..., n, m). The batch axes move last around
    the elimination, so it never returns to the host either."""
    lead_shape = A.shape[:-2]
    n, m = rhs.shape[-2:]
    (X,) = solve_spd_multi(A.reshape((-1, n, n)).permute(1, 2, 0),
                           [rhs.reshape((-1, n, m)).permute(1, 2, 0)])
    return X.permute(2, 0, 1).reshape(lead_shape + (n, m))


# ---------------------------------------------------------------------------
# Fleet problem / spec
# ---------------------------------------------------------------------------


class FleetModelSpec(NamedTuple):
    """Static fleet-native model description.

    f:   (x (..., nx, B), u (..., nu, B), params) -> xdot (..., nx, B)
    fj:  (x, u, params) -> (..., nx, nx+nu, B) continuous Jacobian, read by
         the generic dense path when there is no `edj`; None differentiates
         f by `torch.func.jacfwd` (`models.discretize.autodiff_jacobian_bl`)
    quat_idx: index of the quaternion in x, or None for a vector state
    edj: optional (x, x1, u, params, h) -> (Ae (..., ne, ne, B),
         Be (..., ne, nu, B)), the model's structured error-state discrete
         Jacobian, equal to E(x1)ᵀ·discretize(fj)·E(x)
    integrator: "midpoint" (every fleet controller) or "euler" (the golden
         convex fixture), read by the step and by the dense Jacobian path
    line_search: the model's tag in K2 (`kernels.line_search`), whose
         instantiation for the spec's integrator runs its line search, or
         None for the plain version: "quat_srb" (the quaternion SRB, midpoint
         rule), "euler_srb" (the Euler SRB of the convex baseline, midpoint
         rule or forward Euler) or "attitude" (falling_cat's attitude model,
         midpoint rule); `solver.al_ilqr.fleet_spec` sets it only where that
         instantiation exists
    expansions: the model's tag in K8 (`kernels.expansions`), whose
         instantiation for the spec's integrator then computes the backward
         pass's knot expansions of a problem without state rows Cx, or None
         for the plain version: "quat_srb" (the quaternion SRB's structured
         `edj`, midpoint rule), "euler_srb" (the Euler SRB with its
         `euler_srb_jacobian`, midpoint rule or forward Euler) or "attitude"
         (the attitude model differentiated, midpoint rule);
         `solver.al_ilqr.fleet_spec` sets it only where that instantiation
         exists and the spec asks for the Jacobian it computes
    """

    nx: int
    nu: int
    f: Callable
    fj: Optional[Callable] = None
    quat_idx: Optional[int] = None
    edj: Optional[Callable] = None
    integrator: str = "midpoint"
    line_search: Optional[str] = None
    expansions: Optional[str] = None

    @property
    def ne(self) -> int:
        return self.nx if self.quat_idx is None else self.nx - 1


class FleetProblem(NamedTuple):
    """Batch-last problem. Shapes (B = fleet size):

    x0 (nx, B); x_ref (N+1, nx, B); u_ref (N+1, nu, B); Qd (nx, B) or (nx, 1);
    Rd (nu, ...); w (B,) or (1,) for the whole horizon, or (N+1, B) or
    (N+1, 1) per knot; Cu (nc, nu, B); cb (nc, B) shared or (N+1, nc, B) per
    knot; h scalar or (B,); params of the model (batch-last).

    Qdf (nx, B|1): terminal state weight (None -> Qd). Cx (nc, nx, B|1): state
    rows of the inequality Cx·x + Cu·u + cb ≤ 0, which is then also held at
    the terminal knot (u = 0) and carries N+1 multiplier rows.
    """

    x0: torch.Tensor
    x_ref: torch.Tensor
    u_ref: torch.Tensor
    Qd: torch.Tensor
    Rd: torch.Tensor
    w: torch.Tensor
    Cu: torch.Tensor
    cb: torch.Tensor
    h: torch.Tensor
    params: object
    us_init: torch.Tensor
    # dual warm start: (N, nc, B); with Cx (N+1, nc, B), or (N, nc, B) for a
    # zero terminal row
    lam_init: Optional[torch.Tensor] = None
    Qdf: Optional[torch.Tensor] = None
    Cx: Optional[torch.Tensor] = None


class FleetSolution(NamedTuple):
    xs: torch.Tensor    # (N+1, nx, B)
    us: torch.Tensor    # (N, nu, B)
    cost: torch.Tensor  # (B,)
    iterations: int
    lam: Optional[torch.Tensor] = None  # final AL multipliers: (N, nc, B), with Cx (N+1, nc, B)
    constraint_violation: Optional[torch.Tensor] = None  # (B,) max(c, 0) over the stage knots
    grad_norm: Optional[torch.Tensor] = None  # (B,) max|Qu| of the last backward pass
    active_iterations: Optional[torch.Tensor] = None  # (B,) int32: iterations not yet `done`


def cb_knots(cb: torch.Tensor, n_knots: int) -> torch.Tensor:
    """Constraint offset per stage knot, (n_knots, nc, B): a shared (nc, B)
    cb broadcasts, a per-knot (N+1, nc, B) cb is sliced to the stage knots."""
    if cb.dim() == 3:
        return cb[:n_knots]
    return cb.unsqueeze(0).expand((n_knots,) + cb.shape)


# ---------------------------------------------------------------------------
# Costs and expansions
# ---------------------------------------------------------------------------


def cb_terminal(cb: torch.Tensor) -> torch.Tensor:
    """Constraint offset (nc, B) at the terminal knot."""
    return cb[-1] if cb.dim() == 3 else cb


def w_knots(w: torch.Tensor, knots):
    """Geodesic weight at ``knots`` (a slice or an index of the N+1 knots),
    to broadcast against per-knot (..., B) values: a (B,) or (1,) w is one
    weight for the whole horizon, a (N+1, B|1) w is per knot."""
    return w if w.dim() == 1 else w[knots]


def constraint_values(prob, xs, us):
    """c = Cu·u + cb (+ Cx·x) at the stage knots, (..., N, nc, B)."""
    N = us.shape[-3]
    c = bmv(prob.Cu, us) + cb_knots(prob.cb, N)
    if prob.Cx is not None:
        c = c + bmv(prob.Cx, xs[..., :N, :, :])
    return c


def terminal_constraint_values(prob, xN):
    """c_N = Cx·x_N + cb_N (..., nc, B) of a problem with state rows."""
    return bmv(prob.Cx, xN) + cb_terminal(prob.cb)


def stage_cost_terms(spec, x, u, x_ref, u_ref, prob, w):
    """Per-knot cost value (..., B); ``w`` broadcasts against it."""
    qi = spec.quat_idx
    dx = x - x_ref
    val = 0.5 * torch.sum(prob.Qd * dx * dx, dim=-2)
    du = u - u_ref
    val = val + 0.5 * torch.sum(prob.Rd * du * du, dim=-2)
    if qi is None:
        return val
    dot = torch.sum(x[..., qi : qi + 4, :] * x_ref[..., qi : qi + 4, :], dim=-2)
    return val + w * (1.0 - torch.abs(dot))


def al_value(c, lam, rho):
    lam_bar = torch.clamp(lam + rho * c, min=0.0)
    return (torch.sum(lam_bar * lam_bar, dim=-2) - torch.sum(lam * lam, dim=-2)) / (
        2.0 * rho
    )


def total_cost(spec, xs, us, prob, lam, rho):
    """Augmented-Lagrangian objective (..., B) of trajectories xs (..., N+1, nx, B),
    us (..., N, nu, B) — every stage knot at once, then the terminal term.
    lam (N, nc, B); with state rows Cx (N+1, nc, B), the last row the
    terminal knot's."""
    qi = spec.quat_idx
    N = us.shape[-3]
    c = constraint_values(prob, xs, us)
    stage = stage_cost_terms(
        spec, xs[..., :-1, :, :], us, prob.x_ref[:-1], prob.u_ref[:-1], prob,
        w_knots(prob.w, slice(0, N)),
    ) + al_value(c, lam[:N], rho)
    xN = xs[..., -1, :, :]
    x_refN = prob.x_ref[-1]
    dxN = xN - x_refN
    Qdf = prob.Qd if prob.Qdf is None else prob.Qdf
    term = 0.5 * torch.sum(Qdf * dxN * dxN, dim=-2)
    if qi is not None:
        dot = torch.sum(xN[..., qi : qi + 4, :] * x_refN[qi : qi + 4], dim=-2)
        term = term + w_knots(prob.w, -1) * (1.0 - torch.abs(dot))
    if prob.Cx is not None:
        term = term + al_value(terminal_constraint_values(prob, xN), lam[N], rho)
    return torch.sum(stage, dim=-2) + term


def _state_expansion_structured(x, x_ref, Qd, w, qi, ne):
    """(lx (..., ne, B), lxx (..., ne, ne, B)) of the diagonal-Q +
    geodesic-attitude state cost, blockwise — exactly Eᵀg and
    Eᵀdiag(Qd)E + corr·M without building the projection E = blkdiag(I, G(q), I):
    lxx = diag(Qd_p) ⊕ (G(q)ᵀdiag(Qd_q)G(q) + corr·I₃) ⊕ diag(Qd_rest).
    A vector state (qi None) has lx = Qd·(x − x_ref) and lxx = diag(Qd)."""
    g = Qd * (x - x_ref)  # (..., nx, B)
    lead = torch.broadcast_shapes(x.shape, x_ref.shape)[:-2]
    if qi is None:
        lxx = _eye(ne, x) * Qd.unsqueeze(-3)
        return g, lxx.expand(lead + (ne, ne, g.shape[-1]))
    q = x[..., qi : qi + 4, :]
    q_ref = x_ref[..., qi : qi + 4, :]
    dot = torch.sum(q * q_ref, dim=-2, keepdim=True)
    s = torch.sign(dot)  # sign(0) = 0, as jnp.sign
    g_q = g[..., qi : qi + 4, :] - w * s * q_ref
    corr = -torch.sum(q * g_q, dim=-2)
    G = _quat_G_bl(q)  # (..., 4, 3, B)
    # lx = Eᵀ g, blockwise
    lx = torch.cat(
        [g[..., :qi, :], torch.sum(G * g_q.unsqueeze(-2), dim=-3), g[..., qi + 4 :, :]],
        dim=-2,
    )
    # attitude block: Gᵀ diag(Qd_q) G + corr·I₃
    GQ = Qd[..., qi : qi + 4, :].unsqueeze(-2) * G
    att = torch.sum(G.unsqueeze(-2) * GQ.unsqueeze(-3), dim=-4)
    att = att + _eye(3, x) * corr[..., None, None, :]
    lxx = x.new_zeros(lead + (ne, ne, x.shape[-1]))
    lxx[..., :qi, :qi, :] = _eye(qi, x) * Qd[..., :qi, :].unsqueeze(-3)
    lxx[..., qi : qi + 3, qi : qi + 3, :] = att
    lxx[..., qi + 3 :, qi + 3 :, :] = _eye(ne - qi - 3, x) * Qd[..., qi + 4 :, :].unsqueeze(-3)
    return lx, lxx


def _state_row_terms(spec, prob, x, lam_bar, active, rho):
    """What the state rows Cx add to (lx, lxx), and Cx·E(x) (..., nc, ne, B)."""
    CxE = bmm(prob.Cx, _error_proj_bl(x, spec.quat_idx, spec.ne))
    lx = bmv(bt(CxE), lam_bar)
    lxx = rho * bmm(bt(CxE) * active.unsqueeze(-3), CxE)
    return lx, lxx, CxE


def cost_expansion(spec, x, u, x_ref, u_ref, lam, rho, prob, cb, w):
    """(lx, lxx, lu, luu, lux) at stage knots; ``w`` broadcasts against
    (..., 1, B). lux (..., nu, ne, B) is None without state rows Cx."""
    qi, ne = spec.quat_idx, spec.ne
    lx, lxx = _state_expansion_structured(x, x_ref, prob.Qd, w, qi, ne)
    lu = prob.Rd * (u - u_ref)
    luu = _eye(spec.nu, x) * prob.Rd.unsqueeze(-3)
    c = bmv(prob.Cu, u) + cb
    if prob.Cx is not None:
        c = c + bmv(prob.Cx, x)
    lam_bar = torch.clamp(lam + rho * c, min=0.0)
    active = ((lam + rho * c) >= 0.0).to(x.dtype)
    CuT_active = bt(prob.Cu) * active.unsqueeze(-3)
    lu = lu + bmv(bt(prob.Cu), lam_bar)
    luu = luu + rho * bmm(CuT_active, prob.Cu)
    if prob.Cx is None:
        return lx, lxx, lu, luu, None
    lx_c, lxx_c, CxE = _state_row_terms(spec, prob, x, lam_bar, active, rho)
    return lx + lx_c, lxx + lxx_c, lu, luu, rho * bmm(CuT_active, CxE)


def terminal_expansion(spec, xN, prob, lam=None, rho=None):
    """(lxN, lxxN). A problem with state rows Cx also needs its multipliers
    ``lam`` (N+1, nc, B) and the penalty ``rho``."""
    Qdf = prob.Qd if prob.Qdf is None else prob.Qdf
    lxN, lxxN = _state_expansion_structured(
        xN, prob.x_ref[-1], Qdf, w_knots(prob.w, -1), spec.quat_idx, spec.ne
    )
    if prob.Cx is None:
        return lxN, lxxN
    z = lam[-1] + rho * terminal_constraint_values(prob, xN)
    lx_c, lxx_c, _ = _state_row_terms(
        spec, prob, xN, torch.clamp(z, min=0.0), (z >= 0.0).to(xN.dtype), rho
    )
    return lxN + lx_c, lxxN + lxx_c


def error_discrete_jac(spec, x, x1, u, prob):
    """(Ae, Be): error-state discrete Jacobians at the knots — the model's
    structured form when it has one (spec.edj), else the generic dense path:
    discretize fj, then project through E(x) and E(x1)."""
    if spec.edj is not None:
        return spec.edj(x, x1, u, prob.params, prob.h)
    qi, ne = spec.quat_idx, spec.ne
    Ad, Bd = _fleet_discrete_jac(spec, x, u, prob.params, prob.h)
    E0 = _error_proj_bl(x, qi, ne)
    E1 = _error_proj_bl(x1, qi, ne)
    return bmm(bt(E1), bmm(Ad, E0)), bmm(bt(E1), Bd)


def _structured_q_terms(blocks, Vx, Vxx, lx, lxx, lu, luu):
    """(Qx, Qu, Qxx, Quu, Qux) of a Riccati step written against the quaternion
    SRB's error-state block sparsity (`models.srb.SrbEdjBlocks`):

        Ae = [[I,0,h·I,0],[0,Aφφ,0,Aφω],[0,0,I,0],[0,0,0,I]]
        Be = [[s_p/m·(I…I)],[Bφ],[s_v/m·(I…I)],[s_w·Bω]]

    so that e.g. Aeᵀ·Vxx = [Vp; Aφφᵀ·Vφ; h·Vp+Vv; Aφωᵀ·Vφ+Vω]: two 3-wide
    contractions in place of a dense 12-wide one. No solver path calls it:
    it is the plain version of the Riccati step with the expansions inside
    K1, which is later work (the reference keeps it as the blueprint of such
    a fused kernel too)."""
    h, sp, sv, sw = blocks.h, blocks.s_p, blocks.s_v, blocks.s_w
    inv_m = blocks.inv_m
    Aff, Afw, Bf, Bw = blocks.A_phi, blocks.A_pw, blocks.B_phi, blocks.Bw
    n_feet = Bw.shape[-2] // 3
    mtm = lambda A_, B_: torch.sum(A_.unsqueeze(-2) * B_.unsqueeze(-3), dim=-4)
    mtv = lambda A_, v_: torch.sum(A_ * v_.unsqueeze(-2), dim=-3)
    tile = lambda a, dim: torch.cat([a] * n_feet, dim=dim)

    Vp, Vf, Vv, Vw = (Vxx[..., i : i + 3, :, :] for i in (0, 3, 6, 9))
    AtV = torch.cat([Vp, mtm(Aff, Vf), h * Vp + Vv, mtm(Afw, Vf) + Vw], dim=-3)
    vp, vf, vv, vw = (Vx[..., i : i + 3, :] for i in (0, 3, 6, 9))
    Qx = lx + torch.cat([vp, mtv(Aff, vf), h * vp + vv, mtv(Afw, vf) + vw], dim=-2)
    M0, M1, M2, M3 = (AtV[..., i : i + 3, :] for i in (0, 3, 6, 9))
    Qxx = lxx + torch.cat([M0, bmm(M1, Aff), h * M0 + M2, bmm(M1, Afw) + M3], dim=-2)
    BtV = tile((sp * Vp + sv * Vv) * inv_m, -3) + mtm(Bf, Vf) + sw * mtm(Bw, Vw)
    Qu = lu + (tile((sp * vp + sv * vv) * inv_m, -2) + mtv(Bf, vf) + sw * mtv(Bw, vw))
    N0, N1, N2, N3 = (BtV[..., i : i + 3, :] for i in (0, 3, 6, 9))
    Quu = luu + (tile((sp * N0 + sv * N2) * inv_m, -2) + bmm(N1, Bf) + sw * bmm(N3, Bw))
    Qux = torch.cat([N0, bmm(N1, Aff), h * N0 + N2, bmm(N1, Afw) + N3], dim=-2)
    return Qx, Qu, Qxx, Quu, Qux


def knot_expansions_with_cross(spec, prob, xs, us, lam, rho):
    """All per-knot dynamics/cost expansions at once, knots on a leading
    axis: (As, Bs, lxs, lxxs, lus, luus, luxs); luxs is None without state
    rows Cx."""
    N = us.shape[0]
    x, x1 = xs[:N], xs[1:]
    A, B_ = error_discrete_jac(spec, x, x1, us, prob)
    w = prob.w if prob.w.dim() == 1 else prob.w[:N].unsqueeze(-2)
    lx, lxx, lu, luu, lux = cost_expansion(
        spec, x, us, prob.x_ref[:N], prob.u_ref[:N], lam[:N], rho, prob,
        cb_knots(prob.cb, N), w,
    )
    return A, B_, lx, lxx, lu, luu, lux


def knot_expansions(spec, prob, xs, us, lam, rho):
    """(As, Bs, lxs, lxxs, lus, luus) of a problem without state rows: the
    inputs of `kernels.riccati_sweep` and `kernels.assoc_scan.assoc_backward`."""
    if prob.Cx is not None:
        raise ValueError(
            "a problem with state rows Cx has a cross term lux, which these "
            "expansions leave out: use knot_expansions_with_cross"
        )
    return knot_expansions_with_cross(spec, prob, xs, us, lam, rho)[:6]


def backward_expansions(spec, prob, xs, us, lam, rho):
    """What a backward pass takes of the problem at (xs, us): (As, Bs, lxs,
    lxxs, lus, luus, luxs, lxN, lxxN), luxs None without state rows Cx. A
    spec tagged for K8 (``expansions``) with no state rows runs K8
    (`kernels.expansions`: one launch on the card, its plain version on the
    CPU); every other the plain expansions. Inside a profiler range named
    `EXPANSIONS`."""
    with record_function(EXPANSIONS):
        if spec.expansions is not None and prob.Cx is None:
            *knots, lxN, lxxN = _k8.knot_expansions(spec, prob, xs, us, lam, rho)
            return (*knots, None, lxN, lxxN)
        *knots, luxs = knot_expansions_with_cross(spec, prob, xs, us, lam, rho)
        return (*knots, luxs, *terminal_expansion(spec, xs[-1], prob, lam, rho))


def riccati_backward(spec, prob, xs, us, lam, rho, reg):
    """Backward pass: the expansions (`backward_expansions`), then the K1
    Riccati sweep (the CUDA kernel for CUDA tensors, its plain version on the
    CPU); a problem with state rows Cx hands it the cost's cross term lux as
    well. Returns (Ks, ds, dV1, dV2, max|Qu|)."""
    *expansions, luxs, lxN, lxxN = backward_expansions(spec, prob, xs, us, lam, rho)
    B = xs.shape[-1]
    reg_b = torch.broadcast_to(torch.atleast_1d(reg), (B,))
    args = (*expansions, lxN, lxxN, reg_b)
    return _k1.riccati_sweep(
        *(t.contiguous() for t in args), luxs=None if luxs is None else luxs.contiguous()
    )


def open_loop_rollout(spec, prob, us):
    """States (N+1, nx, B) of the inputs us (N, nu, B) from prob.x0."""
    x = prob.x0
    xs = [x]
    for k in range(us.shape[0]):
        x = _fleet_step(spec, x, us[k], prob.params, prob.h)
        xs.append(x)
    return torch.stack(xs)


def rollout(spec, prob, xs_bar, us_bar, Ks, ds, alpha):
    """Closed-loop rollout u = ū + α·d + K·δx around (xs_bar, us_bar).

    alpha broadcasts against (nu, B): (B,) is one step length per scenario;
    (K, 1, 1) rolls K step lengths at once and returns xs (K, N+1, nx, B),
    us (K, N, nu, B)."""
    qi = spec.quat_idx
    lead = torch.broadcast_shapes(alpha.shape, ds.shape[1:])[:-2]
    x = xs_bar[0].expand(lead + xs_bar[0].shape)
    xs, us = [], []
    for k in range(us_bar.shape[0]):
        dx = _state_diff_bl(x, xs_bar[k], qi)
        u = us_bar[k] + alpha * ds[k] + bmv(Ks[k], dx)
        xs.append(x)
        us.append(u)
        x = _fleet_step(spec, x, u, prob.params, prob.h)
    xs.append(x)
    return torch.stack(xs, dim=-3), torch.stack(us, dim=-3)


# ---------------------------------------------------------------------------
# Solver
# ---------------------------------------------------------------------------


def select_alpha(ok, xs_m, us_m, J_m, J):
    """Per scenario, the rollout of the first (largest) accepted alpha.

    ok, J_m (K, B); xs_m (K, N+1, nx, B), us_m (K, N, nu, B); J (B,).
    Returns (xs_ls, us_ls, J_ls, accepted); where no alpha passed, xs_ls and
    us_ls are zero and J_ls is J. `torch.argmax` rejects bool, so the mask is
    cast first (argmax returns the first maximal index). The select is
    NaN-safe: an unselected alpha's rollout may hold Inf/NaN, and a 0/1
    weighted sum would turn 0·Inf into NaN, so it masks with `where` first.
    """
    accepted = torch.any(ok, dim=0)
    first = torch.argmax(ok.to(torch.int32), dim=0)
    k = torch.arange(ok.shape[0], device=ok.device)
    sel = (k[:, None] == first[None, :]) & ok
    selm = sel[:, None, None, :]
    xs_ls = torch.sum(torch.where(selm, xs_m, 0.0), dim=0)
    us_ls = torch.sum(torch.where(selm, us_m, 0.0), dim=0)
    J_ls = torch.sum(torch.where(sel, J_m, 0.0), dim=0) + torch.where(accepted, 0.0, J)
    return xs_ls, us_ls, J_ls, accepted


def armijo_ok(J, J_m, dV1, dV2, alphas):
    """(K, B) mask of the alphas whose rollout cost J_m (K, B) passes the
    Armijo test against J (B,) and the expected decrease
    −(α·dV1 + α²·dV2), and is finite."""
    expected = -(alphas[:, None] * dV1[None, :] + (alphas**2)[:, None] * dV2[None, :])
    ok = torch.where(
        expected > 0.0,
        (J[None, :] - J_m) / torch.clamp(expected, min=1e-30) > 1e-4,
        J_m < J[None, :] + 1e-12,
    )
    return ok & torch.isfinite(J_m)


def line_search(spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas,
                with_costs=False):
    """One iLQR iteration's line search, plain PyTorch (K2's plain version).

    Backtracking alphas 1, 1/2, ... (K,) evaluated together on a leading K
    axis; per scenario the first alpha passing Armijo is taken — the accept
    semantics of serial backtracking with K tries. ``J`` is the AL cost of
    (xs, us), or None to price them here first: the solver passes None on
    an AL iteration's first iLQR iteration, so that the cost the test
    compares against is summed as the rollouts' costs are (by K2's own
    arithmetic on the card: in f32 a cost summed in another order can differ
    from them by more than the decrease the test asks of the smaller
    alphas). Returns (xs, us,
    J, J_out, accepted, improved): xs and us replaced by the selected
    rollout and J_out its cost where the step improved J in a scenario not
    yet ``done``, J_out = J elsewhere; with ``with_costs`` also the
    rollouts' costs J_m (K, B)."""
    if J is None:
        J = total_cost(spec, xs, us, prob, lam, rho)
    xs_m, us_m = rollout(spec, prob, xs, us, Ks, ds, alphas[:, None, None])
    J_m = total_cost(spec, xs_m, us_m, prob, lam, rho)  # (K, B)
    ok = armijo_ok(J, J_m, dV1, dV2, alphas)
    xs_ls, us_ls, J_ls, accepted = select_alpha(ok, xs_m, us_m, J_m, J)
    improved = accepted & (J_ls < J)
    take = improved & ~done
    xs = torch.where(take[None, None, :], xs_ls, xs)
    us = torch.where(take[None, None, :], us_ls, us)
    J_out = torch.where(take, J_ls, J)
    out = (xs, us, J, J_out, accepted, improved)
    return out + (J_m,) if with_costs else out


def make_fleet_solver(
    spec: FleetModelSpec,
    opts: SolverOptions = SolverOptions(),
    backend: str = "auto",
    stats: bool = False,
):
    """Returns solve(prob: FleetProblem) -> FleetSolution, fully batch-last.

    backend: "sweep", the sequential Riccati sweep (kernel K1) — the
    reference's fleet path ("xla" there); "assoc", the horizon-parallel
    associative-scan backward pass (`parallel_riccati.parallel_backward`,
    kernel K4); "auto" takes "assoc" exactly when B == 1 (the single robot)
    and "sweep" for every fleet, the reference's rule (its fleet.py:713-720);
    a problem with state rows Cx, whose cross term the scan does not take,
    is a sweep under "auto" at any B.
    stats: also return what `SolveStats` holds (constraint_violation,
    grad_norm, active_iterations); off, they are None and cost no launch.
    """
    if backend not in ("sweep", "assoc", "auto"):
        raise ValueError(f"unknown backend {backend!r}")
    # Imported here: parallel_riccati imports this module.
    from quaternion_mpc_tpu_torch.solver import parallel_riccati

    # K2 for a tagged model (its wrapper runs the plain version on the CPU)
    search = line_search if spec.line_search is None else _k2.line_search

    def backward(prob, xs, us, lam, rho, reg):
        single = xs.shape[-1] == 1 and prob.Cx is None
        if backend == "assoc" or (backend == "auto" and single):
            return parallel_riccati.parallel_backward(spec, prob, xs, us, lam, rho, reg)
        return riccati_backward(spec, prob, xs, us, lam, rho, reg)

    def ilqr_iteration(prob, xs, us, lam, rho, reg, J, done, alphas):
        Ks, ds, dV1, dV2, gnorm = backward(prob, xs, us, lam, rho, reg)
        xs, us, J, J_out, accepted, improved = search(
            spec, prob, xs, us, Ks, ds, dV1, dV2, J, done, lam, rho, alphas
        )
        reg = torch.where(
            improved,
            torch.clamp(reg / opts.reg_scale_up, min=opts.reg_initial),
            torch.clamp(reg * opts.reg_scale_up, max=opts.reg_max),
        )
        conv = (torch.abs(J - J_out) < opts.cost_tol) | (gnorm < opts.grad_tol)
        done = done | conv | ~accepted
        return xs, us, reg, J_out, done, gnorm

    def solve(prob: FleetProblem) -> FleetSolution:
        dtype, device = prob.x0.dtype, prob.x0.device
        B = prob.x0.shape[-1]
        N = prob.us_init.shape[0]
        nc = prob.cb.shape[-2]
        # K9 where K2 runs, on a problem without state rows (its wrapper runs
        # the plain versions on the CPU)
        fused = spec.line_search is not None and prob.Cx is None

        us = prob.us_init
        with record_function(OPEN_LOOP):
            xs = _k9.rollout(spec, prob, us) if fused else open_loop_rollout(spec, prob, us)
        # one multiplier row a stage knot, and with state rows a terminal one
        n_lam = N + 1 if prob.Cx is not None else N
        if prob.lam_init is None:
            lam = torch.zeros((n_lam, nc, B), dtype=dtype, device=device)
        elif prob.lam_init.shape[0] == n_lam:
            lam = prob.lam_init
        else:
            lam = torch.cat([prob.lam_init, torch.zeros_like(prob.lam_init[:1])])
        # scalars and the alphas are made on the device (fill kernels): a
        # tensor built from host data would synchronise with the host
        rho = torch.full((), opts.penalty_initial, dtype=dtype, device=device)
        reg = torch.full((B,), opts.reg_initial, dtype=dtype, device=device)
        # 1, 1/2, 1/4, ...: products of halves are exact
        alphas = 2.0 * torch.cumprod(
            torch.full((opts.max_linesearch,), 0.5, dtype=dtype, device=device), dim=0
        )

        n_total = 0
        n_active = torch.zeros((B,), dtype=torch.int32, device=device) if stats else None
        gnorm = None
        for _ in range(opts.al_iterations):
            J = None  # the first line search prices (xs, us) under the new (lam, rho)
            done = torch.zeros((B,), dtype=torch.bool, device=device)
            for _ in range(opts.ilqr_iterations):
                if stats:
                    n_active = n_active + (~done).to(torch.int32)
                xs, us, reg, J, done, gnorm = ilqr_iteration(
                    prob, xs, us, lam, rho, reg, J, done, alphas
                )
                n_total += 1
            with record_function(PRICING):
                if fused:
                    lam = _k9.price(spec, prob, xs, us, lam, rho, cost=False, lam_bar=True)[1]
                else:
                    lam_stage = torch.clamp(lam[:N] + rho * constraint_values(prob, xs, us),
                                            min=0.0)
                    if prob.Cx is None:
                        lam = lam_stage
                    else:
                        lam_N = lam[N] + rho * terminal_constraint_values(prob, xs[-1])
                        lam = torch.cat([lam_stage, torch.clamp(lam_N, min=0.0)[None]])
            rho = rho * opts.penalty_scaling

        # the final cost: zero multipliers at a vanishing penalty
        rho_final = torch.full((), 1e-30, dtype=dtype, device=device)
        with record_function(PRICING):
            if fused:
                final_cost = _k9.price(spec, prob, xs, us, None, rho_final)[0]
            else:
                final_cost = total_cost(spec, xs, us, prob, torch.zeros_like(lam), rho_final)
        if not stats:
            return FleetSolution(xs=xs, us=us, cost=final_cost, iterations=n_total, lam=lam)
        if nc > 0:
            c = constraint_values(prob, xs, us)
            violation = torch.amax(torch.clamp(c, min=0.0), dim=(0, 1))
        else:
            violation = torch.zeros((B,), dtype=dtype, device=device)
        if gnorm is None:  # no iteration ran
            gnorm = torch.full((B,), float("inf"), dtype=dtype, device=device)
        return FleetSolution(
            xs=xs, us=us, cost=final_cost, iterations=n_total, lam=lam,
            constraint_violation=violation, grad_norm=gnorm, active_iterations=n_active,
        )

    return solve
