"""Grid-native ZZ error estimation on the lattice spec (PyTorch twin of
pelvistim_fem_tpu/ops/stencil_estimate.py, without the sharded and the
EQS forms).

ops/estimate needs the (M, 4) tet array, per-tet gradients and a node
scatter: the host materialisation the lattice-spec path exists to avoid.
This module computes the SAME by-body ZZ indicators directly on the
(X, Y, Z) node grid:

- Kuhn class t (permutation p) spans the axis-aligned edge path
  c0 -> c0+e_p0 -> +e_p1 -> (1,1,1), so its P1 gradient solves the 3x3
  system E g = d with E the path edge vectors and d the successive phi
  differences: a cross-product inversion per cell.  Edges come from the
  knots plus the spec's coordinate deviations, so deformed lattices are
  exact.
- The volume-weighted per-body nodal recovery is 8 shifted slice-adds per
  class (in place, in the reference's order) instead of a scatter.
- The indicators reduce to an (nx, ny, nz) per-CELL eta^2 grid whose axis
  sums are the adapt_axis weights directly (cells are knot intervals).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from pelvistim_fem_tpu_torch.device import DEFAULT_DEVICE, resolve_device

__all__ = ["lattice_zz_error", "lattice_axis_weights_from_cells",
           "lattice_dual_spec", "lattice_goal_weights"]

# class order matches mesh/generate._KUHN (itertools.permutations); the
# path-edge gradient solve does not depend on the vertex order
_PERMS = tuple(itertools.permutations(range(3)))


def _corners(perm):
    o1 = tuple(int(i == perm[0]) for i in range(3))
    o2 = tuple(int(i in (perm[0], perm[1])) for i in range(3))
    return ((0, 0, 0), o1, o2, (1, 1, 1))


def _cross(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _lattice_zz_core(phi_g, coords, body6, sigma_table, n_bodies):
    """phi_g (X, Y, Z); coords (3, X, Y, Z); body6 (6, nx, ny, nz) int
    (0 = carved); sigma_table (n_bodies + 1,).  Returns (eta2 per class
    and cell (6, nx, ny, nz), en2)."""
    X, Y, Z = phi_g.shape
    cx, cy, cz = X - 1, Y - 1, Z - 1

    def corner(a, o):
        return a[..., o[0]:cx + o[0], o[1]:cy + o[1], o[2]:cz + o[2]]

    gs, Vs, cns = [], [], []
    for p in _PERMS:
        cs = _corners(p)
        xc = [corner(coords, o) for o in cs]          # 4 x (3, cells)
        e1, e2, e3 = xc[1] - xc[0], xc[2] - xc[1], xc[3] - xc[2]
        pc = [corner(phi_g, o) for o in cs]
        d1, d2, d3 = pc[1] - pc[0], pc[2] - pc[1], pc[3] - pc[2]
        c23, c31, c12 = _cross(e2, e3), _cross(e3, e1), _cross(e1, e2)
        det = torch.sum(e1 * c23, 0)
        g = (d1 * c23 + d2 * c31 + d3 * c12) \
            / torch.where(det == 0, 1.0, det)
        gs.append(g)                                   # (3, cells)
        Vs.append(torch.abs(det) / 6.0)                # (cells,)
        cns.append(cs)

    dt, dev = phi_g.dtype, phi_g.device
    eta2 = torch.zeros((6, cx, cy, cz), dtype=dt, device=dev)
    en2 = torch.zeros((), dtype=dt, device=dev)
    for b in range(1, n_bodies + 1):
        # per-body volume-weighted recovery (8 slice-adds per class)
        num = torch.zeros((3, X, Y, Z), dtype=dt, device=dev)
        den = torch.zeros((X, Y, Z), dtype=dt, device=dev)
        ws = []
        for t in range(6):
            w = torch.where(body6[t] == b, Vs[t], 0.0)
            ws.append(w)
            wg = w * gs[t]
            for o in cns[t]:
                num[:, o[0]:cx + o[0], o[1]:cy + o[1],
                    o[2]:cz + o[2]] += wg
                den[o[0]:cx + o[0], o[1]:cy + o[1], o[2]:cz + o[2]] += w
        Gb = num / torch.clamp(den, min=1e-300)

        sig = sigma_table[b]
        for t in range(6):
            ds = [corner(Gb, o) - gs[t] for o in cns[t]]
            sumd = ds[0] + ds[1] + ds[2] + ds[3]
            quad = torch.sum(sumd * sumd, 0)
            for d in ds:
                quad = quad + torch.sum(d * d, 0)
            eta2[t] += ws[t] / 20.0 * sig * quad
            en2 = en2 + torch.sum(ws[t] * sig * torch.sum(gs[t] * gs[t], 0))
    return eta2, en2


def lattice_zz_error(spec, phi, sigma_table=None, *, dtype=torch.float64,
                     device=DEFAULT_DEVICE):
    """By-body ZZ indicators of a LatticeSpec solve, with no tets.

    phi: (N,) mesh-node solution (a tensor, put on `device`, or an
    array).  Returns dict: eta2_cells (nx, ny, nz) per-cell squared
    indicators (a cell sums its 6 Kuhn tets), eta2_class (6, nx, ny, nz),
    eta (global estimate), en2 (the energy norm squared) and rel (eta
    relative to the energy norm); the same numbers as
    ops/estimate.zz_error_indicators on the spec's tets."""
    device = resolve_device(device)
    X, Y, Z = spec.used.shape
    xs, ys, zs = spec.axes
    tab = (np.asarray(spec.sigma_table, np.float64)
           if sigma_table is None else np.asarray(sigma_table))
    if tab.ndim != 1:
        raise ValueError("lattice_zz_error: scalar sigma tables only "
                         "(tensor bodies: use the element path's "
                         "zz_error_indicators)")
    phi = torch.as_tensor(phi).to(dtype=dtype, device=device)
    phi_g = torch.zeros(X * Y * Z, dtype=dtype, device=device)
    phi_g[torch.as_tensor(spec.grid_index, device=device)] = phi
    phi_g = phi_g.reshape(X, Y, Z)
    kx = np.broadcast_to(np.asarray(xs)[:, None, None], (X, Y, Z))
    ky = np.broadcast_to(np.asarray(ys)[None, :, None], (X, Y, Z))
    kz = np.broadcast_to(np.asarray(zs)[None, None, :], (X, Y, Z))
    coords = torch.as_tensor(
        np.stack([kx, ky, kz]) + np.asarray(spec.coords_dev)).to(
            dtype=dtype, device=device)
    eta2_class, en2 = _lattice_zz_core(
        phi_g, coords, torch.as_tensor(spec.body6, device=device),
        torch.as_tensor(tab).to(dtype=dtype, device=device),
        int(spec.n_bodies))
    eta2 = torch.sum(eta2_class, 0)
    eta = torch.sqrt(torch.sum(eta2))
    return {"eta2_cells": eta2, "eta2_class": eta2_class, "eta": eta,
            "en2": en2,
            "rel": eta / torch.sqrt(torch.clamp(en2, min=1e-300))}


def lattice_dual_spec(spec, q_nodes):
    """The dual spec of a linear goal J = q^T phi on the lattice path:
    the spec bakes its electrode load into b_neumann, so the dual is a
    field swap (homogeneous Dirichlet data, b_neumann = q on the grid).
    For pure-Neumann (current-mode) specs the goal must have sum q = 0."""
    X, Y, Z = spec.used.shape
    qg = np.zeros(X * Y * Z, np.float64)
    qg[np.asarray(spec.grid_index)] = np.asarray(q_nodes, np.float64)
    return dataclasses.replace(
        spec, dirichlet=np.zeros_like(spec.dirichlet),
        b_neumann=qg.reshape(X, Y, Z))


def lattice_goal_weights(est_u, est_z):
    """Per-cell goal weights sum_t eta_u,t * eta_z,t from two
    lattice_zz_error results (primal and dual): the per-tet bound
    contributions summed per cell.  Their total is the estimated goal
    error bound |J(u) - J(u_h)|; feed them to adapt_axis via axis sums
    with power=1."""
    wu = torch.sqrt(torch.clamp(est_u["eta2_class"], min=0.0))
    wz = torch.sqrt(torch.clamp(est_z["eta2_class"], min=0.0))
    return torch.sum(wu * wz, 0)


def lattice_axis_weights_from_cells(eta2_cells):
    """[wx, wy, wz] adapt_axis error-mass weights from the per-cell
    indicator grid: a plain sum over the perpendicular axes (host
    numpy)."""
    if isinstance(eta2_cells, torch.Tensor):
        eta2_cells = eta2_cells.detach().cpu().numpy()
    e = np.asarray(eta2_cells, np.float64)
    return [e.sum(axis=(1, 2)), e.sum(axis=(0, 2)), e.sum(axis=(0, 1))]
