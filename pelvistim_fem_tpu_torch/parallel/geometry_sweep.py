"""Geometry sweeps as one lane-stacked batch (PyTorch twin of
pelvistim_fem_tpu/parallel/geometry_sweep.py).

Two kinds of batch, both solved with one operator per lane through the
4-D stencil_spmv (kernel 1 with a lane axis):

  * a t_fat group (step03): every fat thickness of one electrode radius
    on one lattice, whose z-knots are the union of every case's knots, so
    the meshes coincide node for node and the cases differ only in which
    cells are fat and which muscle: a coefficient stack per lane, shared
    BCs (`build_t_fat_group`, `solve_t_fat_group`);
  * a padded group (step02): cases whose lattices differ, each embedded
    at the origin of their common envelope and padded with inert planes
    (non-free, zero coefficients and loads), so each lane solves exactly
    its serial operator (`build_padded_group`), with a multigrid
    hierarchy per lane on shared index-space transfers
    (`build_padded_group_hierarchy`).
"""

from __future__ import annotations

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pelvistim_fem_tpu_torch.mesh.grading import layered_z_axis
from pelvistim_fem_tpu_torch.ops.lattice_assembly import _hierarchy
from pelvistim_fem_tpu_torch.ops.multigrid import MGHierarchy, MGLevel
from pelvistim_fem_tpu_torch.ops.stencil import (
    StencilCase, batched_geometry_solve_refined, build_stencil_case,
    stencil_host_data)


def shared_z_knots(params, t_fat_list, *, coarse=False):
    """Union of all cases' z-knot vectors (each case's layer interfaces
    stay exact knots)."""
    g = params["geometry"]
    Lz = g["Lz"]
    ls = params["layers"]
    t_skin = ls["t_skin"]
    ct = params.get("contact", {})
    contact_on = bool(ct.get("enabled", False)) and \
        ct.get("model", "layer") == "layer"
    t_contact = ct.get("t_contact_mm", 0.5) * 1e-3 if contact_on else 0.0

    m = params.get("mesh", {})
    scale = 2.0 if coarse else 1.0
    lc_bulk = m.get("lc_global_mm", 3.0) * 1e-3 * scale
    lc_min = m.get("lc_skin_min", 0.5) * 1e-3 * scale

    knots = []
    for t_fat in t_fat_list:
        t_muscle = Lz - t_skin - t_fat
        interfaces = [0.0, t_muscle, t_muscle + t_fat, Lz]
        hs = [lc_bulk, min(lc_bulk, max(t_fat / 2, lc_min)),
              max(t_skin / 3, lc_min / 2)]
        if contact_on:
            interfaces.append(Lz + t_contact)
            hs.append(t_contact)
        knots.append(layered_z_axis(interfaces, hs))
    return np.unique(np.round(np.concatenate(knots), 12))


def build_t_fat_group(params, t_fat_list, elec_r, *, coarse=False,
                      dtype=torch.float32, device=DEFAULT_DEVICE):
    """The shared-lattice case group of one electrode radius on `device`:
    (scase, coeff_stack (S, B, 27, X, Y, Z), cases, meshes), the cases
    and meshes per t_fat for the metric rows."""
    from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
    device = resolve_device(device)
    zs = shared_z_knots(params, t_fat_list, coarse=coarse)

    cases, meshes, hds = [], [], []
    for t_fat in t_fat_list:
        case, _, mesh = build_layered_case(
            params, t_fat=t_fat, elec_r=elec_r, coarse=coarse, dtype=dtype,
            with_mesh=True, explicit_zs=zs, device=device)
        cases.append(case)
        meshes.append(mesh)
        hds.append(stencil_host_data(case, mesh))

    ref = meshes[0]
    for m in meshes[1:]:
        if m.lattice.grid_shape != ref.lattice.grid_shape or \
                not np.array_equal(m.lattice.grid_index,
                                   ref.lattice.grid_index):
            raise AssertionError("t_fat group lattices do not coincide")

    scase = build_stencil_case(cases[0], meshes[0], dtype=dtype,
                               host_data=hds[0], device=device)
    coeff_stack = torch.stack([torch.as_tensor(h["coeff"], dtype=dtype,
                                               device=device) for h in hds])
    return scase, coeff_stack, cases, meshes


def solve_t_fat_group(params, t_fat_list, elec_r, *, coarse=False,
                      tol=1e-8, maxiter=30_000, device=DEFAULT_DEVICE):
    """One lane-stacked solve of a whole t_fat group, built in f64 and
    certified on every lane's TRUE f64 residual (f32 inner Jacobi-PCG):
    (SolveResult with phi (S, N), cases, meshes)."""
    f64 = torch.float64
    scase, coeff_stack, cases, meshes = build_t_fat_group(
        params, t_fat_list, elec_r, coarse=coarse, dtype=f64, device=device)
    tables = torch.stack([c.sigma_table for c in cases]).to(f64)
    out = batched_geometry_solve_refined(scase, coeff_stack, tables,
                                         tol=tol, maxiter=maxiter)
    return out, cases, meshes


def build_padded_group(case_mesh_list, dtype=torch.float64,
                       device=DEFAULT_DEVICE):
    """Stack cases whose lattices differ onto one padded grid on `device`:
    (StencilCase with a leading lane axis S on coeff, free, dirichlet,
    b_neumann and sigma_table, extract).  Each case's grid sits at the
    origin of the (Xmax, Ymax, Zmax) envelope; the padding is inert, so
    the padded operator is exactly the serial one.  grid_index is the
    identity of the padded grid: the batched solvers return phi (S, G),
    and extract(phi (S, G)) gives the list of per-case mesh-node phi."""
    device = resolve_device(device)
    hds = [stencil_host_data(c, m) for c, m in case_mesh_list]
    S = len(hds)
    shapes = [h["free"].shape for h in hds]
    Xm = max(s[0] for s in shapes)
    Ym = max(s[1] for s in shapes)
    Zm = max(s[2] for s in shapes)
    Bm = max(h["coeff"].shape[0] for h in hds)
    Tm = max(len(h["sigma_table"]) for h in hds)

    def padg(a):
        X, Y, Z = a.shape[-3:]
        cfg = [(0, 0)] * (a.ndim - 3) + [(0, Xm - X), (0, Ym - Y),
                                         (0, Zm - Z)]
        return np.pad(a, cfg)

    coeffs = np.stack([
        padg(np.pad(h["coeff"], [(0, Bm - h["coeff"].shape[0]), (0, 0),
                                 (0, 0), (0, 0), (0, 0)])) for h in hds])
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    G = Xm * Ym * Zm
    stacked = StencilCase(
        coeff=f(coeffs),
        free=torch.as_tensor(np.stack([padg(h["free"]) for h in hds]),
                             device=device),
        dirichlet=f(np.stack([padg(h["dirichlet"]) for h in hds])),
        b_neumann=f(np.stack([padg(h["b_neumann"]) for h in hds])),
        grid_index=torch.arange(G, device=device),
        sigma_table=f(np.stack([np.pad(h["sigma_table"],
                                       (0, Tm - len(h["sigma_table"])))
                                for h in hds])),
    )
    index = [torch.as_tensor(h["grid_index"], dtype=torch.int64,
                             device=device) for h in hds]

    def extract(phi_grid):
        pg = phi_grid.reshape(S, Xm, Ym, Zm)
        return [pg[s, :X, :Y, :Z].reshape(-1)[index[s]]
                for s, (X, Y, Z) in enumerate(shapes)]

    return stacked, extract


def build_padded_group_hierarchy(stacked):
    """Per-lane multigrid hierarchies of a padded group, stacked into one
    MGHierarchy with a leading lane axis on every level.

    Each lane is Galerkin-probed on the device (lattice_assembly's
    _hierarchy, the batched kernel with the 27 probe combs as lanes) in
    f64 and its levels then cast to float32, the inner solve's dtype.  The lanes' lattices have
    different graded knots, but every lane coarsens on the same
    index-space axes (np.arange) of the shared envelope, so all share
    lane 0's transfers: transfers shape the preconditioner only, never
    the certified answer."""
    S = stacked.coeff.shape[0]
    X, Y, Z = stacked.free.shape[1:]
    axes = (np.arange(X, dtype=float), np.arange(Y, dtype=float),
            np.arange(Z, dtype=float))
    hiers = [_hierarchy(stacked.coeff[s].to(torch.float64), stacked.free[s],
                        axes) for s in range(S)]
    n_levels = len(hiers[0].levels)
    if any(len(h.levels) != n_levels for h in hiers):
        raise AssertionError("padded group lanes differ in level count")
    levels = tuple(
        MGLevel(coeff=torch.stack([h.levels[l].coeff for h in hiers]
                                  ).to(torch.float32),
                free=torch.stack([h.levels[l].free for h in hiers]))
        for l in range(n_levels))
    return MGHierarchy(levels=levels, transfers=hiers[0].transfers)
