"""Lead-field solves and injected-current-pattern design (PyTorch twin
of pelvistim_fem_tpu/ops/leadfield.py).

The lead-field matrix of a K-electrode array is K solves of ONE operator:
only the Neumann load differs (models/array.py builds the basis specs on
a shared lattice).  Here that is one lane-stacked certified MG solve with
a load per lane (multigrid.batched_mg_solve_refined), the bodies'
coefficients read once for all lanes; an ensemble of S conductivity
samples is S*K lanes of the same solve.

By superposition, phi(i) = sum_k i_k phi_k for any injected pattern i in
R^K (the return pad carries -sum i_k), so stimulation design (maximize
directional E in a target ROI subject to a total-current budget,
per-electrode caps and a skin current-density safety limit) is a small
convex program over the lead vectors, solved by Frank-Wolfe on the
device.  The ascent runs its steps with no host read: the best iterate is
kept by torch.where.  Its gradient is written out: a max over cells (or
a min over samples) passes its gradient to its tied maxima in equal
shares, as JAX differentiates jnp.max.  Products over the electrode axis
are elementwise multiply-sums, never a (TF32-capable) matmul.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pelvistim_fem_tpu_torch.mesh import core
from pelvistim_fem_tpu_torch.ops.fields import cell_centers, cell_E, cell_J
from pelvistim_fem_tpu_torch.ops.multigrid import (MGHierarchy,
                                                   batched_mg_solve_fused,
                                                   batched_mg_solve_refined)
from pelvistim_fem_tpu_torch.ops.solve import (SolveResult, _case_astype,
                                               _case_operator, batched_cg,
                                               refine_lanes)
from pelvistim_fem_tpu_torch.ops.stencil import StencilCase


def _with_loads(scase, loads):
    """scase with the load stack `loads` (K, X, Y, Z) and its sigma table
    repeated for each load."""
    K = loads.shape[0]
    sig = scase.sigma_table[None].expand(K, -1).contiguous()
    return dataclasses.replace(scase, b_neumann=loads), sig


def solve_basis_refined(scase: StencilCase, hier: MGHierarchy, loads, *,
                        tol=1e-8, inner_tol=3e-4, maxiter=2_000, nu=2,
                        coarse_iters=24, max_refinements=8) -> SolveResult:
    """K certified solves of one operator with K Neumann loads.

    loads: (K, X, Y, Z) grid-form b_neumann stack (each basis spec's
    `b_neumann`), on the case's device.  Returns a K-lane SolveResult
    with TRUE f64-certified residuals; converged lanes freeze."""
    sc, sig = _with_loads(scase, loads)
    return batched_mg_solve_refined(
        sc, hier, sig, tol=tol, inner_tol=inner_tol, maxiter=maxiter, nu=nu,
        coarse_iters=coarse_iters, max_refinements=max_refinements)


def solve_basis(scase: StencilCase, hier: MGHierarchy, loads, *, tol=1e-8,
                maxiter=2_000, nu=2, coarse_iters=24) -> SolveResult:
    """Uncertified variant of solve_basis_refined: one MG-CG in the
    case's dtype (multigrid.batched_mg_solve_fused)."""
    sc, sig = _with_loads(scase, loads)
    return batched_mg_solve_fused(sc, hier, sig, tol=tol, maxiter=maxiter,
                                  nu=nu, coarse_iters=coarse_iters)


def solve_basis_ensemble_refined(scase: StencilCase, hier: MGHierarchy,
                                 loads, sigma_tables, *, tol=1e-8,
                                 inner_tol=3e-4, maxiter=2_000, nu=2,
                                 coarse_iters=24,
                                 max_refinements=8) -> SolveResult:
    """(S, K) certified solves: lead-field basis k under conductivity
    sample s, as S*K lanes of one solve in s-major order (sigma enters at
    combine time, the load at right-hand-side build time; no
    re-assembly).  sigma_tables (S, T).  Returns phi (S, K, N) and
    iterations, residual, converged (S, K)."""
    S, K = sigma_tables.shape[0], loads.shape[0]
    sc = dataclasses.replace(scase, b_neumann=loads.repeat(S, 1, 1, 1))
    r = batched_mg_solve_refined(
        sc, hier, sigma_tables.repeat_interleave(K, dim=0), tol=tol,
        inner_tol=inner_tol, maxiter=maxiter, nu=nu,
        coarse_iters=coarse_iters, max_refinements=max_refinements)
    return SolveResult(phi=r.phi.reshape(S, K, -1),
                       iterations=r.iterations.reshape(S, K),
                       residual=r.residual.reshape(S, K),
                       converged=r.converged.reshape(S, K))


def element_patch_loads(case, patch_id, I_unit=1.0) -> np.ndarray:
    """(K, N) basis Neumann loads (numpy, float64) for K electrode patches
    on an ELEMENT mesh.

    patch_id: (B,) int per boundary face, 0 = not an electrode, 1..K =
    patch membership.  Each patch gets the P1-consistent load of a
    uniform injected current density jn = I_unit / patch_area (the
    construction of ops/bc.neumann_current_load, so the discrete
    delivered current is exact per patch)."""
    faces = case.faces.cpu().numpy()
    area = case.face_area.cpu().numpy().astype(np.float64)
    patch_id = np.asarray(patch_id)
    K = int(patch_id.max())
    n = int(case.free_mask.shape[0])
    loads = np.zeros((K, n))
    for k in range(1, K + 1):
        sel = patch_id == k
        A = float(area[sel].sum())
        if A <= 0:
            raise ValueError(f"patch {k} has zero area")
        contrib = (I_unit / A) * area[sel] / 3.0
        np.add.at(loads[k - 1], faces[sel].reshape(-1),
                  np.repeat(contrib, 3))
    return loads


def solve_basis_case_refined(case, loads, *, amg=None, tol=1e-8,
                             inner_tol=1e-6, maxiter=10_000,
                             max_refinements=4) -> SolveResult:
    """K certified element-path solves of one Case with K Neumann loads
    (K, N): lead fields on a mesh without a lattice.  The K lanes are one
    lane-stacked f32 inner solve, refined against the f64 operator to a
    TRUE f64 residual per lane (solve.refine_lanes): Jacobi-PCG inner
    passes with the settings given (those of solve.solve_case_refined),
    or, with amg (ops/amg.build_amg), AMG-CG inner passes with the
    settings of amg.solve_case_amg_refined."""
    if amg is not None:
        from pelvistim_fem_tpu_torch.ops.amg import solve_case_amg_refined
        return solve_case_amg_refined(case, amg, tol=tol, loads=loads)
    f32, f64 = torch.float32, torch.float64
    case64, case32 = _case_astype(case, f64), _case_astype(case, f32)
    loads = torch.as_tensor(loads, dtype=f64, device=case.nodes.device)
    free = case.free_mask
    op64, _, b64 = _case_operator(
        dataclasses.replace(case64, b_neumann=loads),
        case.sigma_table.to(f64))
    op32, diag32, _ = _case_operator(case32, case.sigma_table.to(f32))
    minv = torch.where(diag32 > 0, 1.0 / diag32, torch.ones_like(diag32))

    def inner(r32, tol_k):
        x, _, k = batched_cg(op32, r32, lambda r: minv * r,
                             torch.zeros_like(r32), tol=tol_k,
                             maxiter=maxiter)
        return x, k

    x0 = torch.where(free, 0.0, case64.dirichlet_vals).expand(
        b64.shape).clone()
    x, rel, it = refine_lanes(op64, b64, x0, inner, tol=tol,
                              inner_tol=inner_tol,
                              max_refinements=max_refinements)
    return SolveResult(phi=x, iterations=it, residual=rel,
                       converged=rel <= tol)


def lead_vectors(case, phi_basis, *, roi_center, roi_r, target_dir,
                 sigma_table=None):
    """Reduce K basis potentials phi_basis (K, N) to the design's inputs.

    Returns (w, J_skin, vol_roi):
      w      (K,)        mean E . target_dir over the ROI ball per unit
                         basis pattern (volume-weighted, V/m)
      J_skin (K, Ms, 3)  per-basis current-density lead vectors on the
                         skin-body cells (A/m^2), the safety surface
      vol_roi            ROI volume actually covered (m^3)
    The skin cells are chosen on the host from tet_body."""
    dev = phi_basis.device
    d = cell_centers(case) - torch.as_tensor(np.asarray(roi_center),
                                             device=dev)
    roi = torch.sum(d * d, dim=1) <= roi_r * roi_r
    wvol = torch.where(roi, case.vol, 0.0)
    vol_roi = torch.sum(wvol)
    tdir = torch.as_tensor(np.asarray(target_dir), dtype=phi_basis.dtype,
                           device=dev)
    tdir = tdir / torch.sqrt(torch.sum(tdir * tdir))
    (skin_idx,) = np.nonzero(case.tet_body.cpu().numpy() == core.BODY_SKIN)
    skin_idx = torch.as_tensor(skin_idx, device=dev)
    E = cell_E(case, phi_basis)                            # (K, M, 3)
    w = torch.sum(wvol * torch.sum(E * tdir, dim=-1), dim=-1) / vol_roi
    J = cell_J(case, phi_basis, sigma_table)
    return w, J[..., skin_idx, :], vol_roi


def _lmo(g, budget, i_max):
    """argmax over |i| <= i_max, ||i||_1 <= budget of <g, i>: channels
    filled at i_max in descending |g_k| (ties in index order, as JAX's
    stable argsort) until the budget runs out."""
    K = g.shape[-1]
    order = torch.argsort(-torch.abs(g), stable=True)
    fill = torch.minimum(torch.clamp(
        budget - i_max * torch.arange(K, dtype=g.dtype, device=g.device),
        min=0.0), i_max)
    return torch.sign(g) * torch.zeros_like(g).scatter(0, order, fill)


def _skin_peak(i, J_skin):
    """(J, q, qmax, peak) of pattern i on J_skin (K, M, 3), or (S, K, M,
    3) for S samples: J = sum_k i_k J_skin_k per cell, q = |J|^2, qmax
    its max over cells (and samples), peak = sqrt(qmax)."""
    J = torch.sum(i[:, None, None] * J_skin, dim=-3)
    q = torch.sum(J * J, dim=-1)
    qmax = torch.amax(q)
    return J, q, qmax, torch.sqrt(qmax)


def _peak_vjp(J_skin, J, q, qmax, peak, ct):
    """ct * d peak / d i (K,): the max's share split evenly between its
    tied cells, in JAX's reverse-mode order (sqrt, max, square, sum)."""
    ind = (q == qmax).to(q.dtype)
    ct_cells = (ct * (0.5 / peak)) / torch.sum(ind) * ind
    ct_J = 2.0 * (ct_cells[..., None] * J)
    g = torch.sum(ct_J.unsqueeze(-3) * J_skin, dim=(-2, -1))
    return g.reshape(-1, g.shape[-1]).sum(0)


def _frank_wolfe(value, J_skin, i0, wnorm, *, budget, i_max, j_limit,
                 steps, candidates=()):
    """Frank-Wolfe ascent of value(i) - mu max(peak(i) - j_limit, 0)^2
    over the box/l1 set from i0, keeping the iterate (or candidate) of
    the best feasible value value(s i), s = min(1, j_limit / peak(i)).
    value(i) -> (v, dv/di).  Returns (best i shrunk onto the skin limit,
    history of each step's feasible value)."""
    mu = torch.clamp(wnorm * budget, min=1e-30) / \
        torch.clamp(j_limit * j_limit, min=1e-30)

    def scale(peak):
        return torch.clamp(j_limit / torch.clamp(peak, min=1e-30), max=1.0)

    def scaled(i, peak):
        return value(scale(peak) * i)[0]

    i = i0
    state = _skin_peak(i, J_skin)
    best_i, best_f = i, scaled(i, state[3])
    for c in candidates:
        fc = scaled(c, _skin_peak(c, J_skin)[3])
        take = fc > best_f
        best_i = torch.where(take, c, best_i)
        best_f = torch.where(take, fc, best_f)
    ts = torch.arange(steps, dtype=i0.dtype, device=i0.device)
    gams = 2.0 / (ts + 2.0)
    hist = torch.empty_like(ts)
    for t in range(steps):
        peak = state[3]
        excess = peak - j_limit
        v = torch.clamp(excess, min=0.0)
        # d max(x, 0) / dx as JAX takes it: 1, 1/2 at the tie, 0
        slope = (excess > 0).to(excess.dtype) + \
            0.5 * (excess == 0).to(excess.dtype)
        ct_peak = -2.0 * (mu * v) * slope
        g = value(i)[1] + _peak_vjp(J_skin, *state, ct_peak)
        s = _lmo(g, budget, i_max)
        gam = gams[t]
        i = (1.0 - gam) * i + gam * s
        state = _skin_peak(i, J_skin)
        f = scaled(i, state[3])
        better = f > best_f
        best_i = torch.where(better, i, best_i)
        best_f = torch.where(better, f, best_f)
        hist[t] = f
    return best_i * scale(_skin_peak(best_i, J_skin)[3]), hist


def _as(x, ref):
    return torch.as_tensor(x, dtype=ref.dtype, device=ref.device)


def optimize_pattern(w, J_skin, *, budget, i_max, j_limit, steps=400):
    """Frank-Wolfe ascent for the injected current pattern.

        maximize   w . i                      (ROI directional E)
        subject to sum_k |i_k| <= budget      (total delivered current)
                   |i_k|       <= i_max       (per-channel compliance)
                   max_cell |sum_k i_k J_k|
                              <= j_limit      (skin safety limit)

    The box-cap-l1 set has an analytic linear-maximization oracle (fill
    channels in decreasing |gradient| at i_max until the budget runs
    out), so every iterate is feasible by convexity.  The skin limit
    enters as a smooth concave penalty during the ascent plus an exact
    post-scaling of the best iterate, so the returned pattern is feasible
    by construction.  w (K,), J_skin (K, M, 3) tensors on one device.
    Returns (i, info dict of device scalars)."""
    budget, i_max, j_limit = (_as(v, w) for v in (budget, i_max, j_limit))

    def value(i):
        return torch.sum(w * i), w

    i, hist = _frank_wolfe(value, J_skin, _lmo(w, budget, i_max),
                           torch.sqrt(torch.sum(w * w)), budget=budget,
                           i_max=i_max, j_limit=j_limit, steps=steps)
    info = {"objective": torch.sum(w * i),
            "peak_J_skin": _skin_peak(i, J_skin)[3],
            "l1": torch.sum(torch.abs(i)), "linf": torch.amax(torch.abs(i)),
            "history": hist}
    return i, info


def optimize_pattern_robust(w_sk, J_skin_sk, *, budget, i_max, j_limit,
                            steps: int = 400, candidates=None):
    """Worst-case Frank-Wolfe over conductivity samples.

        maximize   min_s  w_s . i          (worst-sample ROI dose)
        subject to the constraints of optimize_pattern, with the skin
                   peak taken over ALL samples.

    min_s of linear functions is concave, so Frank-Wolfe applies (the
    gradient is the active sample's w); the penalty and the exact
    post-scaling see the sample-wise worst peak, so the pattern is
    feasible for every sample.  w_sk (S, K); J_skin_sk (S, K, M, 3).
    `candidates` (C, K), optional: box/l1-feasible warm starts (e.g. the
    nominal design) entered into the best-iterate tracking.  Returns (i,
    info) with the worst and mean objectives."""
    budget, i_max, j_limit = (_as(v, w_sk)
                              for v in (budget, i_max, j_limit))

    def value(i):
        vals = torch.sum(w_sk * i, dim=-1)
        m = torch.amin(vals)
        ind = (vals == m).to(vals.dtype)
        return m, torch.sum((ind / torch.sum(ind))[:, None] * w_sk, dim=0)

    wbar = w_sk.mean(dim=0)
    cands = () if candidates is None else _as(candidates, w_sk)
    i, hist = _frank_wolfe(value, J_skin_sk, _lmo(wbar, budget, i_max),
                           torch.sqrt(torch.sum(wbar * wbar)),
                           budget=budget, i_max=i_max, j_limit=j_limit,
                           steps=steps, candidates=cands)
    vals = torch.sum(w_sk * i, dim=-1)
    info = {"objective_worst": torch.amin(vals),
            "objective_mean": torch.mean(vals),
            "peak_J_skin": _skin_peak(i, J_skin_sk)[3],
            "l1": torch.sum(torch.abs(i)), "linf": torch.amax(torch.abs(i)),
            "history": hist}
    return i, info
