"""Device-side stencil assembly + multigrid setup from a LatticeSpec
(PyTorch twin of the certified-solve slice of
pelvistim_fem_tpu/ops/lattice_assembly.py).

From the compact host spec (knot axes, coordinate deviations, per-class
cell bodies, BC grids) the device builds (and, for sigma(|E|) laws,
reads |grad phi| per tet back off the grid, `lattice_cell_e_mag`):

    coefficients  — per-Kuhn-class closed-form P1 stiffness from cell
                    corner coordinates, accumulated as shifted adds;
    MG hierarchy  — Galerkin probing: R A_b P read off with period-3
                    comb vectors, one batched stencil apply per body and
                    a phase-indexed gather per level.

Numerics: edge vectors are rebuilt as (exact 1-D knot difference) +
(deviation difference), so f32 per-cell gradients are accurate to f32
roundoff of the EDGE.
"""

from __future__ import annotations

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device
from pelvistim_fem_tpu_torch.mesh.generate import _KUHN
from pelvistim_fem_tpu_torch.mesh.spec import LatticeSpec
from pelvistim_fem_tpu_torch.ops.multigrid import (MGHierarchy, MGLevel,
                                                   Transfer,
                                                   solve_stencil_mg_refined)
from pelvistim_fem_tpu_torch.ops.stencil import (OFFSETS, StencilCase,
                                                 batched_stencil_spmv)

_OFFSET_INDEX = {off: o for o, off in enumerate(OFFSETS)}


def _kuhn_class_areas(h_axes, coords_dev, c):
    """Per-cell corner AREA vectors + |det| for one Kuhn class.

    Returns (ns, adet): ns a list of 4 corner area vectors (3-tuples)
    with e_i . A_j = det delta_ij, so grad phi = sum_a phi_a n_a / det
    and K_ab = sigma n_a.n_b / (6 |det|)."""
    X, Y, Z = coords_dev.shape[1:]
    nx, ny, nz = X - 1, Y - 1, Z - 1

    def corner_dev(cc):
        return coords_dev[:, cc[0]:cc[0] + nx, cc[1]:cc[1] + ny,
                          cc[2]:cc[2] + nz]

    d0 = corner_dev(c[0])
    es = []
    for k in (1, 2, 3):
        dk = corner_dev(c[k]) - d0
        comps = []
        for ax in range(3):
            delta = int(c[k, ax]) - int(c[0, ax])
            comp = dk[ax]
            if delta != 0:
                shape = [1, 1, 1]
                shape[ax] = (nx, ny, nz)[ax]
                comp = comp + delta * h_axes[ax].reshape(shape)
            comps.append(comp)
        es.append(comps)
    e1, e2, e3 = es

    def cross(a, b):
        return (a[1] * b[2] - a[2] * b[1],
                a[2] * b[0] - a[0] * b[2],
                a[0] * b[1] - a[1] * b[0])

    A1 = cross(e2, e3)
    A2 = cross(e3, e1)
    A3 = cross(e1, e2)
    det = e1[0] * A1[0] + e1[1] * A1[1] + e1[2] * A1[2]
    ns = [tuple(-(A1[i] + A2[i] + A3[i]) for i in range(3)),
          A1, A2, A3]
    return ns, torch.abs(det)


def lattice_cell_e_mag(h_axes, coords_dev, phi_grid):
    """|grad phi| per (Kuhn class, cell): (6, nx, ny, nz) from a
    grid-shaped potential (X, Y, Z).  On each tet grad phi = sum_a
    phi(corner_a) n_a / det; carved cells (zero |det|) give 0.  The
    lattice form of the element |E| that feeds sigma(|E|) laws."""
    X, Y, Z = phi_grid.shape
    nx, ny, nz = X - 1, Y - 1, Z - 1

    def corner_phi(cc):
        return phi_grid[cc[0]:cc[0] + nx, cc[1]:cc[1] + ny,
                        cc[2]:cc[2] + nz]

    outs = []
    for t in range(6):
        c = _KUHN[t]
        ns, adet = _kuhn_class_areas(h_axes, coords_dev, c)
        g = [torch.zeros((nx, ny, nz), dtype=phi_grid.dtype,
                         device=phi_grid.device) for _ in range(3)]
        for a in range(4):
            pa = corner_phi(c[a])
            for i in range(3):
                g[i] = g[i] + pa * ns[a][i]
        mag2 = g[0] ** 2 + g[1] ** 2 + g[2] ** 2
        inv = torch.where(adet > 0, 1.0 / torch.clamp(adet, min=1e-300),
                          0.0)
        outs.append(torch.sqrt(mag2) * inv)
    return torch.stack(outs)


def lattice_coeff(h_axes, coords_dev, body6, n_bodies: int,
                  sigma_table=None, sigma_cell=None):
    """Per-body stencil coefficient stacks (B, 27, X, Y, Z) from grid
    geometry, on the device of `coords_dev`.

    h_axes: per-cell knot spacings (hx (nx,), hy (ny,), hz (nz,)),
    differenced on the host in f64.  coords_dev: (3, X, Y, Z) node
    deviation from the knot grid.  body6: (6, nx, ny, nz) int8 per-(cell,
    Kuhn class) body id (0 = carved).

    sigma_table (n_bodies + 1,) with slot 0 == 0: weight each cell by
    its body's sigma during accumulation and return the pre-combined
    (1, 27, X, Y, Z) stack (single-sigma solves never hold per-body
    stacks).

    sigma_table may also be a (n_bodies + 1, 3, 3) table of symmetric
    tensors (ops/aniso; slot 0 all zero): the cell integrand is then
    n_a^T Sigma n_b / (6 |det|), pre-combined to B = 1 likewise.  Every
    branch is plain PyTorch ops, differentiable with respect to the table
    in reverse and forward mode (ops/adjoint.solve_lattice_mg_diff).

    sigma_cell (6, nx, ny, nz): a conductivity per (Kuhn class, cell),
    for laws where every tet has its own sigma (ops/nonlinear); also
    pre-combined to (1, 27, X, Y, Z).  The caller zeroes carved cells.
    Mutually exclusive with sigma_table."""
    if sigma_table is not None and sigma_cell is not None:
        raise ValueError("pass sigma_table or sigma_cell, not both")
    dt = coords_dev.dtype
    dev = coords_dev.device
    X, Y, Z = coords_dev.shape[1:]
    nx, ny, nz = X - 1, Y - 1, Z - 1
    B_out = n_bodies if sigma_table is None and sigma_cell is None else 1

    tensor = sigma_table is not None and sigma_table.dim() == 3
    per_off = [[] for _ in range(27)]
    bids = torch.arange(1, n_bodies + 1, dtype=torch.int64, device=dev)
    for t in range(6):
        c = _KUHN[t]
        ns, adet = _kuhn_class_areas(h_axes, coords_dev, c)
        inv6det = torch.where(adet > 0, 1.0 / (6.0 * adet), 0.0)
        if sigma_cell is not None:
            weight = sigma_cell[t][None].to(dt)
        elif sigma_table is None:
            weight = (body6[t][None].to(torch.int64)
                      == bids[:, None, None, None]).to(dt)
        elif tensor:
            # a 3x3 a cell, gathered from the small table; carved cells
            # (body 0) hit the all-zero slot
            bt = body6[t].to(torch.int64)
            S = [[sigma_table[bt, i, j].to(dt) for j in range(3)]
                 for i in range(3)]
        else:
            # carved cells (body 0) hit sigma_table[0] == 0
            weight = sigma_table[body6[t].to(torch.int64)][None].to(dt)
        for a in range(4):
            for b in range(a, 4):
                if tensor:
                    k_ab = sum(ns[a][i] * S[i][j] * ns[b][j]
                               for i in range(3)
                               for j in range(3)) * inv6det
                    contrib = k_ab[None]           # (1, nx, ny, nz)
                else:
                    k_ab = (ns[a][0] * ns[b][0] + ns[a][1] * ns[b][1]
                            + ns[a][2] * ns[b][2]) * inv6det
                    contrib = k_ab[None] * weight  # (B_out, nx, ny, nz)
                o_ab = _OFFSET_INDEX[tuple(c[b] - c[a])]
                per_off[o_ab].append((tuple(c[a]), contrib))
                if a != b:
                    o_ba = _OFFSET_INDEX[tuple(c[a] - c[b])]
                    per_off[o_ba].append((tuple(c[b]), contrib))

    out = torch.zeros((B_out, 27, X, Y, Z), dtype=dt, device=dev)
    for o in range(27):
        acc = out[:, o]
        for da, contrib in per_off[o]:
            acc[:, da[0]:da[0] + nx, da[1]:da[1] + ny,
                da[2]:da[2] + nz] += contrib
    return out


def _comb_vectors(shape, dt, device):
    """(27, Xc, Yc, Zc) period-3 probing combs; comb c has phase
    ((dx+1), (dy+1), (dz+1)) of OFFSETS[c]."""
    Xc, Yc, Zc = shape
    ix = torch.arange(Xc, device=device) % 3
    iy = torch.arange(Yc, device=device) % 3
    iz = torch.arange(Zc, device=device) % 3
    phases = torch.tensor([(dx + 1, dy + 1, dz + 1)
                           for dx, dy, dz in OFFSETS], device=device)
    return ((ix[None, :, None, None] == phases[:, 0, None, None, None])
            & (iy[None, None, :, None] == phases[:, 1, None, None, None])
            & (iz[None, None, None, :] == phases[:, 2, None, None, None])
            ).to(dt)


def _spmv_all(pf, coeff):
    """Y[b, c] = A_b pf[c]: one batched stencil apply per body, the 27
    combs as lanes with unit sigma."""
    ones = torch.ones((pf.shape[0], 1), dtype=pf.dtype, device=pf.device)
    pf = pf.contiguous()
    return torch.stack([batched_stencil_spmv(pf, coeff[b:b + 1].contiguous(),
                                             ones)
                        for b in range(coeff.shape[0])])


def _probe_level(coeff, free, transfer: Transfer, coarse_shape):
    """Galerkin-probe one coarsening on the device: (B, 27, Xc, Yc, Zc)."""
    dt = coeff.dtype
    dev = coeff.device
    Xc, Yc, Zc = coarse_shape
    combs = _comb_vectors(coarse_shape, dt, dev)            # (27, coarse)
    pf = torch.where(free[None], transfer.prolong(combs), 0.0)
    ys = _spmv_all(pf, coeff)                               # (B, 27, fine)
    ys = transfer.restrict(torch.where(free[None, None], ys, 0.0))

    # for target node n and offset d the source comb is the one whose
    # phase == (n + d) mod 3; out-of-range sources are zero
    ix = torch.arange(Xc, device=dev)
    iy = torch.arange(Yc, device=dev)
    iz = torch.arange(Zc, device=dev)
    d = torch.tensor(OFFSETS, device=dev)                   # (27, 3)
    sx = ix[None, :, None, None] + d[:, 0, None, None, None]
    sy = iy[None, None, :, None] + d[:, 1, None, None, None]
    sz = iz[None, None, None, :] + d[:, 2, None, None, None]
    cidx = (sx % 3) * 9 + (sy % 3) * 3 + (sz % 3)          # (27, coarse)
    valid = ((sx >= 0) & (sx < Xc) & (sy >= 0) & (sy < Yc)
             & (sz >= 0) & (sz < Zc))
    out = torch.gather(ys, 1, cidx[None].expand(ys.shape))
    return out * valid[None].to(dt)


def _hierarchy(coeff, free, axes, *, min_nodes=100, max_levels=8):
    """Galerkin hierarchy from the fine per-body stacks (same coarsening
    schedule, transfers and probing math as the reference)."""
    levels = [MGLevel(coeff=coeff, free=free)]
    transfers = []
    cur_axes = tuple(np.asarray(a, float) for a in axes)
    cur_coeff, cur_free = coeff, free
    while len(levels) < max_levels:
        shape = tuple(len(a) for a in cur_axes)
        if int(np.prod(shape)) <= min_nodes:
            break
        tr = Transfer(cur_axes)
        cc = _probe_level(cur_coeff, cur_free, tr, tr.nc)
        cfree = torch.abs(cc).sum(dim=(0, 1)) > 0
        levels.append(MGLevel(coeff=cc, free=cfree))
        transfers.append(tr)
        cur_axes, cur_coeff, cur_free = tr.coarse_axes, cc, cfree
    return MGHierarchy(levels=tuple(levels), transfers=tuple(transfers))


def spec_device_arrays(spec: LatticeSpec, dtype=torch.float32,
                       device=DEFAULT_DEVICE) -> dict:
    """One host -> device copy of the compact spec (a few MB)."""
    device = resolve_device(device)
    f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
    return dict(
        h_axes=tuple(f(np.diff(np.asarray(a, np.float64)))
                     for a in spec.axes),
        coords_dev=f(spec.coords_dev),
        body6=torch.as_tensor(spec.body6, device=device),
        free=torch.as_tensor(spec.free, device=device),
        dirichlet=f(spec.dirichlet),
        b_neumann=f(spec.b_neumann),
        grid_index=torch.as_tensor(spec.grid_index, dtype=torch.int64,
                                   device=device),
        sigma_table=f(spec.sigma_table),
    )


def assemble_lattice(spec: LatticeSpec, dtype=torch.float32, *,
                     device=DEFAULT_DEVICE, device_arrays=None,
                     min_nodes=100, max_levels=8):
    """(StencilCase, MGHierarchy) built on the device from the spec: the
    per-body coefficient stacks and their Galerkin hierarchy, all in
    `dtype`.  Given `device_arrays`, their device is used."""
    dev = device_arrays or spec_device_arrays(spec, dtype, device)
    coeff = lattice_coeff(dev["h_axes"], dev["coords_dev"], dev["body6"],
                          spec.n_bodies)
    scase = StencilCase(coeff=coeff, free=dev["free"],
                        dirichlet=dev["dirichlet"],
                        b_neumann=dev["b_neumann"],
                        grid_index=dev["grid_index"],
                        sigma_table=dev["sigma_table"])
    hier = _hierarchy(coeff, dev["free"], spec.axes, min_nodes=min_nodes,
                      max_levels=max_levels)
    return scase, hier


def solve_lattice_mg_refined(spec: LatticeSpec, sigma_table=None, *,
                             tol=1e-8, inner_tol=3e-4, maxiter=2_000,
                             nu=2, coarse_iters=24, max_refinements=8,
                             min_nodes=100, max_levels=8,
                             device=DEFAULT_DEVICE, device_arrays=None):
    """Assemble (f64) + coarsen (f32) + mixed-precision MG solve.  The
    returned residual is the TRUE f64 relative residual.

    The f64 master operator is pre-combined with the single sigma during
    accumulation (C(sigma) is linear in sigma, so probing the combined
    operator gives the hierarchy the per-body probe would after
    combining, at 1/B the memory); the hierarchy is probed from its f32
    cast, since the V-cycle only has to be a good f32 preconditioner.
    sigma_table may be a (T, 3, 3) tensor table (ops/aniso): the master
    operator is then its pre-combined tensor stencil."""
    dev = device_arrays or spec_device_arrays(spec, torch.float64, device)
    sig = (dev["sigma_table"] if sigma_table is None
           else torch.as_tensor(sigma_table, dtype=torch.float64,
                                device=dev["coords_dev"].device))
    coeff64 = lattice_coeff(dev["h_axes"], dev["coords_dev"], dev["body6"],
                            spec.n_bodies, sigma_table=sig)
    sig2 = torch.tensor([0.0, 1.0], dtype=coeff64.dtype,
                        device=coeff64.device)
    scase64 = StencilCase(coeff=coeff64, free=dev["free"],
                          dirichlet=dev["dirichlet"],
                          b_neumann=dev["b_neumann"],
                          grid_index=dev["grid_index"], sigma_table=sig2)
    hier32 = _hierarchy(coeff64.to(torch.float32), dev["free"], spec.axes,
                        min_nodes=min_nodes, max_levels=max_levels)
    return solve_stencil_mg_refined(
        scase64, hier32, sig2, tol=tol, inner_tol=inner_tol,
        maxiter=maxiter, nu=nu, coarse_iters=coarse_iters,
        max_refinements=max_refinements)
