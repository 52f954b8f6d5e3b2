"""A-posteriori error estimation and adaptive lattice regrading (PyTorch
twin of pelvistim_fem_tpu/ops/estimate.py: the scalar- and 3x3-sigma
estimators, the goal-oriented indicators and the axis regrading).

The Zienkiewicz-Zhu (ZZ) recovered-gradient estimator: any P1 solve
gives per-element energy-norm error indicators at the cost of one
volume-weighted nodal averaging and one quadrature contraction, with no
extra solve.  With g_h = grad phi_h constant per tet and G* the
volume-weighted nodal recovery, d = G*|_e - g_h is LINEAR on each tet, so
the indicator integrates exactly via int lambda_i lambda_j =
V (1 + delta_ij) / 20:

    eta_e^2 = int_e d^T sigma d dV
            = V/20 * [ s(sum_i d_i, sum_i d_i) + sum_i s(d_i, d_i) ],

s(a, b) = a^T sigma b (scalar or 3x3 sigma per body).

On tensor-product lattices the indicators drive 1-D knot
equidistribution: project them onto each axis, rebuild each knot vector
so equal error mass falls in each interval, and mesh again with locked
knots (layer interfaces) kept.

Device functions follow the case's device; every contraction is an
elementwise product and sum, never a (TF32-capable) einsum or matmul.
The host parts (axis weights, adapt_axis, adapt_recipe) are numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from pelvistim_fem_tpu_torch.ops import assembly
from pelvistim_fem_tpu_torch.ops.fields import cell_gradient, nodal_average

__all__ = ["zz_recovered_gradient", "zz_error_indicators",
           "zz_global_error", "adapt_axis", "lattice_axis_weights",
           "goal_dual_case", "zz_goal_indicators", "zz_goal_bound",
           "adapt_recipe"]


def zz_recovered_gradient(case, phi):
    """(N, 3) ZZ-recovered nodal gradient: the volume-weighted average
    of the incident tets' constant P1 gradients."""
    return nodal_average(case, cell_gradient(case, phi))


def _recovered_by_body(case, g, n_bodies):
    """(B, N, 3) per-body recovered gradients: body b's recovery averages
    only over body-b tets.  At a material interface the true gradient is
    discontinuous (flux continuity divides it by the sigma jump), so a
    global average there is wrong by O(1) whatever h; per-body patches
    restore the smooth-field recovery on each side.  Nodes a body never
    touches get a guarded 0/eps entry that no element of that body
    reads."""
    ones4 = torch.ones((1, 4), dtype=g.dtype, device=g.device)
    outs = []
    for b in range(n_bodies):
        w = case.vol * (case.tet_body == b)
        den = assembly.scatter_to_nodes(w[:, None] * ones4,
                                        case.scatter_table)
        num = [assembly.scatter_to_nodes((w * g[:, k])[:, None] * ones4,
                                         case.scatter_table)
               for k in range(3)]
        outs.append(torch.stack(num, 1)
                    / torch.clamp(den, min=1e-300)[:, None])
    return torch.stack(outs)


def _sigma_bilinear(sig_e, a, b):
    """s(a, b) = a^T sigma b per element; sig_e (M,) or (M, 3, 3), a and
    b (M, ..., 3) with matching leading axes."""
    if sig_e.dim() == 3:
        sig = sig_e.reshape((sig_e.shape[0],) + (1,) * (b.dim() - 2)
                            + (3, 3))
        sb = (sig * b[..., None, :]).sum(-1)
    else:
        sb = sig_e.reshape(sig_e.shape + (1,) * (b.dim() - 1)) * b
    return (a * sb).sum(-1)


def zz_error_indicators(case, phi, sigma_table=None, *, by_body=True):
    """Per-element ZZ energy-norm error indicators eta_e, (M,).

    sigma_table (T,) or (T, 3, 3) overrides case.sigma_table.
    by_body=True (default) recovers gradients within each body separately,
    which layered tissue needs (across a sigma jump the global average is
    O(1) wrong); by_body=False is the textbook single-material form."""
    tab = case.sigma_table if sigma_table is None else sigma_table
    g = cell_gradient(case, phi)                       # (M, 3)
    if by_body and int(tab.shape[0]) > 1:
        Gb = _recovered_by_body(case, g, int(tab.shape[0]))
        Gs_e = Gb[case.tet_body[:, None], case.tets]   # (M, 4, 3)
    else:
        Gs_e = nodal_average(case, g)[case.tets]
    d = Gs_e - g[:, None, :]                           # (M, 4, 3)
    sig_e = tab[case.tet_body]
    diag = _sigma_bilinear(sig_e, d, d).sum(1)         # (M,)
    ds = d.sum(1)                                      # (M, 3)
    tot = _sigma_bilinear(sig_e, ds, ds)               # (M,)
    eta2 = case.vol / 20.0 * (tot + diag)
    return torch.sqrt(torch.clamp(eta2, min=0.0))


def zz_global_error(case, phi, sigma_table=None):
    """(eta, rel): the global estimated energy error sqrt(sum eta_e^2),
    and the same relative to the solution's energy norm
    sqrt(sum_e V_e g^T sigma g)."""
    tab = case.sigma_table if sigma_table is None else sigma_table
    eta = zz_error_indicators(case, phi, sigma_table)
    g = cell_gradient(case, phi)
    en2 = torch.sum(case.vol * _sigma_bilinear(tab[case.tet_body], g, g))
    eta_g = torch.sqrt(torch.sum(eta * eta))
    return eta_g, eta_g / torch.sqrt(torch.clamp(en2, min=1e-300))


def goal_dual_case(case, q):
    """The dual problem of a linear goal J(phi) = q^T phi: K psi = q with
    HOMOGENEOUS Dirichlet data on the primal's constrained nodes (K is
    symmetric, so only the data changes).  q (N,) are the goal's nodal
    weights; entries on Dirichlet nodes are masked by the solver."""
    dt = case.dirichlet_vals
    return dataclasses.replace(
        case, dirichlet_vals=torch.zeros_like(dt),
        b_neumann=torch.as_tensor(q).to(dtype=dt.dtype, device=dt.device))


def zz_goal_indicators(case, phi, psi, sigma_table=None):
    """Dual-weighted (goal-oriented) element indicators
    w_e = eta_e(phi) * eta_e(psi): by Galerkin orthogonality the error of
    a linear goal is bounded by sum_e |u - u_h|_{E,e} |z - z_h|_{E,e},
    each factor estimated by the ZZ indicator of its solution."""
    return (zz_error_indicators(case, phi, sigma_table)
            * zz_error_indicators(case, psi, sigma_table))


def zz_goal_bound(case, phi, psi, sigma_table=None):
    """Estimated bound on |J(u) - J(u_h)| for the linear goal whose dual
    solution is psi: sum_e eta_e(phi) eta_e(psi)."""
    return torch.sum(zz_goal_indicators(case, phi, psi, sigma_table))


def lattice_axis_weights(case, mesh, knots_xyz, eta, *, power=2):
    """Per-interval error mass on the three lattice axes (host numpy):
    each tet's eta^power binned by its centroid's knot interval on each
    axis.  power=2 for energy indicators, power=1 for goal indicators
    (zz_goal_indicators), which are already the per-element bound
    contributions.  Returns [wx, wy, wz], (len(knots) - 1,) each."""
    if isinstance(eta, torch.Tensor):
        eta = eta.cpu().numpy()
    eta2 = np.asarray(eta, np.float64) ** power
    tets = case.tets.cpu().numpy()
    cc = np.asarray(mesh.nodes)[tets].mean(axis=1)
    out = []
    for ax, knots in enumerate(knots_xyz):
        k = np.asarray(knots, np.float64)
        idx = np.clip(np.searchsorted(k, cc[:, ax]) - 1, 0, len(k) - 2)
        out.append(np.bincount(idx, weights=eta2, minlength=len(k) - 1))
    return out


def adapt_axis(knots, w_cell, n_cells, *, keep=(), floor=0.02,
               h_min=None):
    """New monotone knot vector equidistributing error mass (host numpy).

    knots (K+1,) the current axis; w_cell (K,) nonnegative per-interval
    error mass; n_cells: intervals of the adapted axis.  keep: coordinates
    that must stay exact knots; cells go to the kept segments in
    proportion to their error mass (>= 1 each).  floor: every interval
    keeps at least floor * max density.  h_min caps refinement.

    Equidistributed density rho_i = w_i^(1/3) / len_i: with local error
    mass per length m(x) = C(x)^2 h(x)^2 (P1), minimising int C^2 h^2 dx
    at fixed int dx/h = n_cells gives h ~ C^(-2/3), i.e. knot density
    (w_i / len_i^3)^(1/3)."""
    k = np.asarray(knots, np.float64)
    w = np.asarray(w_cell, np.float64)
    if len(k) != len(w) + 1:
        raise ValueError(f"knots ({len(k)}) must be w_cell ({len(w)})+1")
    lo, hi = k[0], k[-1]
    kept = np.unique(np.concatenate(
        [[lo, hi], np.asarray(list(keep), np.float64)]))
    seg_edges = kept[(kept >= lo - 1e-12) & (kept <= hi + 1e-12)]
    n_seg = len(seg_edges) - 1
    if n_cells < n_seg:
        raise ValueError(f"n_cells={n_cells} < {n_seg} kept segments")

    lens = np.diff(k)
    rho = np.cbrt(w) / np.maximum(lens, 1e-300)
    rho = np.maximum(rho, floor * rho.max() if rho.max() > 0 else 1.0)
    # cumulative error mass F (piecewise linear, strictly increasing)
    F = np.concatenate([[0.0], np.cumsum(rho * lens)])

    def mass(a, b):
        return np.interp(b, k, F) - np.interp(a, k, F)

    seg_mass = np.array([mass(seg_edges[s], seg_edges[s + 1])
                         for s in range(n_seg)])
    # proportional cell allocation, >= 1 a segment, exact total
    alloc = np.maximum(1, np.floor(
        n_cells * seg_mass / seg_mass.sum()).astype(int))
    while alloc.sum() > n_cells:
        alloc[np.argmax(alloc)] -= 1
    while alloc.sum() < n_cells:
        # the largest mass per cell gets the spare
        alloc[np.argmax(seg_mass / alloc)] += 1

    new = [lo]
    for s in range(n_seg):
        a, b = seg_edges[s], seg_edges[s + 1]
        m = alloc[s]
        Fa, Fb = np.interp(a, k, F), np.interp(b, k, F)
        levels = Fa + (Fb - Fa) * np.arange(1, m) / m
        # invert the monotone piecewise-linear F on [a, b]
        xs = np.interp(levels, F, k)
        seg_knots = np.concatenate([xs, [b]])
        if h_min is not None:
            # minimum spacing left to right, and against the fixed
            # segment end b, which must survive as it is
            prev = a
            out = []
            for x in seg_knots[:-1]:
                if x - prev >= h_min and b - x >= h_min:
                    out.append(x)
                    prev = x
            seg_knots = np.concatenate([out, [b]])
        new.extend(seg_knots.tolist())
    arr = np.array(new)
    # dedupe (kept points can coincide with equidistribution points)
    return arr[np.concatenate([[True], np.diff(arr) > 1e-12])]


def adapt_recipe(recipe, case, mesh, eta, *, keep_x=(), keep_y=(),
                 keep_z=(), n_cells_xyz=None, power=2, h_min=None):
    """One estimate -> regrade cycle on a LatticeRecipe: equidistribute
    the projected error mass on each axis and return a NEW recipe with the
    same classifier callbacks.  keep_z must include the layer-interface z
    knots (bodies are classified by cell centroid).  n_cells_xyz: target
    interval counts (default: the current ones, a redistribution at equal
    cost).  power=1 for goal indicators."""
    knots = (recipe.xs, recipe.ys, recipe.zs)
    w = lattice_axis_weights(case, mesh, knots, eta, power=power)
    if n_cells_xyz is None:
        n_cells_xyz = tuple(len(k) - 1 for k in knots)
    keeps = (keep_x, keep_y, keep_z)
    new = [adapt_axis(k, wk, n, keep=kp, h_min=h_min)
           for k, wk, n, kp in zip(knots, w, n_cells_xyz, keeps)]
    return dataclasses.replace(recipe, xs=new[0], ys=new[1], zs=new[2])
