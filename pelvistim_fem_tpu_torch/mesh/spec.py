"""Compact lattice problem spec: host prep for device-side assembly
(numpy twin of pelvistim_fem_tpu/mesh/spec.py; every field is
bit-identical to the JAX package's).

A generated lattice problem is fully described by the knot axes, the
(deformed) node-coordinate grid, a per-(cell, Kuhn class) body-id grid
and the electrode-face data on the extreme z-planes.  This module builds
exactly that in vectorized numpy; ops/lattice_assembly.py turns it into
stencil coefficients and a multigrid hierarchy on the device.

BC contract: electrode faces (bcid 1 = active / 2 = return) lie on the
extreme z-planes of the lattice.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pelvistim_fem_tpu_torch.mesh.core import BC_ACTIVE, BC_RETURN
from pelvistim_fem_tpu_torch.mesh.generate import _KUHN, LatticeRecipe

# Kuhn classes owning a triangle on the cell's z-extreme faces:
# (class, (3, 3) corner offsets).
_TOP_FACES = []
_BOT_FACES = []
for _t in range(6):
    for _f in range(4):
        _tri = np.delete(_KUHN[_t], _f, axis=0)
        if (_tri[:, 2] == 1).all():
            _TOP_FACES.append((_t, _tri.copy()))
        if (_tri[:, 2] == 0).all():
            _BOT_FACES.append((_t, _tri.copy()))
assert len(_TOP_FACES) == 2 and len(_BOT_FACES) == 2


@dataclasses.dataclass
class LatticeSpec:
    """Host-side (numpy) grid-form problem data.

    coords_dev is the node-coordinate DEVIATION from the knot grid: edge
    vectors are rebuilt on the device as exact knot difference plus
    deviation difference, which keeps f32 edges free of cancellation
    against absolute coordinates."""
    axes: tuple              # (xs, ys, zs) f64 knot vectors
    coords_dev: np.ndarray   # (3, X, Y, Z) f64 deviation from knot grid
    body6: np.ndarray        # (6, nx, ny, nz) int8 per-(cell, class) body
    n_bodies: int
    used: np.ndarray         # (X, Y, Z) bool — node touches a kept tet
    free: np.ndarray         # (X, Y, Z) bool — solve dofs
    dirichlet: np.ndarray    # (X, Y, Z) f64
    b_neumann: np.ndarray    # (X, Y, Z) f64
    grid_index: np.ndarray   # (N,) int64 — mesh-node -> flat grid slot
    sigma_table: np.ndarray  # (n_bodies + 1,) f64
    mode: str
    jn: float
    area_active: float
    area_return: float

    @property
    def grid_shape(self):
        return self.used.shape


def _class_centroid_axis(knots: np.ndarray, s: float) -> np.ndarray:
    """Per-cell tet-centroid coordinate along one axis for a Kuhn class
    with `s` corners at +1 on that axis."""
    lo = np.asarray(knots[:-1], np.float64)
    hi = np.asarray(knots[1:], np.float64)
    return (lo * (4.0 - s) + hi * s) / 4.0


def _electrode_faces_on_plane(spec_faces, xs, ys, zs, coords, body6,
                              bcid_fn, k_plane, normal_z):
    """Classify and integrate the per-class triangles on one extreme
    z-plane.  Returns (active (2, nx, ny) bool, return (2, nx, ny) bool,
    areas (2, nx, ny) f64, tris), leading axis over the plane's two Kuhn
    face classes."""
    nx, ny = len(xs) - 1, len(ys) - 1
    cell_k = 0 if k_plane == 0 else len(zs) - 2
    node_k = k_plane
    act = np.zeros((2, nx, ny), bool)
    ret = np.zeros((2, nx, ny), bool)
    areas = np.zeros((2, nx, ny))
    tris = []
    for fi, (t, tri) in enumerate(spec_faces):
        tris.append(tri)
        kept = body6[t, :, :, cell_k] > 0
        # classification uses the undeformed face centroid
        fx = sum(xs[tri[v, 0]:tri[v, 0] + nx] for v in range(3)) / 3.0
        fy = sum(ys[tri[v, 1]:tri[v, 1] + ny] for v in range(3)) / 3.0
        fxg = np.broadcast_to(fx[:, None], (nx, ny)).ravel()
        fyg = np.broadcast_to(fy[None, :], (nx, ny)).ravel()
        fz = np.full(nx * ny, zs[k_plane])
        zero = np.zeros(nx * ny)
        bcid = np.asarray(bcid_fn(fxg, fyg, fz, zero, zero,
                                  np.full(nx * ny, float(normal_z))),
                          np.int32).reshape(nx, ny)
        act[fi] = kept & (bcid == BC_ACTIVE)
        ret[fi] = kept & (bcid == BC_RETURN)
        # areas of the DEFORMED triangles
        p = [coords[:, tri[v, 0]:tri[v, 0] + nx,
                     tri[v, 1]:tri[v, 1] + ny, node_k] for v in range(3)]
        e1 = p[1] - p[0]
        e2 = p[2] - p[0]
        cx = e1[1] * e2[2] - e1[2] * e2[1]
        cy = e1[2] * e2[0] - e1[0] * e2[2]
        cz = e1[0] * e2[1] - e1[1] * e2[0]
        areas[fi] = 0.5 * np.sqrt(cx * cx + cy * cy + cz * cz)
    return act, ret, areas, tris


def build_lattice_spec(recipe: LatticeRecipe, sigma_by_body: dict, *,
                       mode: str = "voltage", active_V: float = 1.0,
                       injected_current_A: float = 0.0) -> LatticeSpec:
    """Vectorized numpy spec build: no tet array, no boundary
    extraction; the grid is the data structure."""
    xs = np.asarray(recipe.xs, float)
    ys = np.asarray(recipe.ys, float)
    zs = np.asarray(recipe.zs, float)
    X, Y, Z = len(xs), len(ys), len(zs)
    nx, ny, nz = X - 1, Y - 1, Z - 1

    # per-(cell, class) body ids from undeformed tet centroids
    s = _KUHN.sum(axis=1).astype(np.float64)            # (6, 3)
    body6 = np.empty((6, nx, ny, nz), np.int8)
    for t in range(6):
        cx = _class_centroid_axis(xs, s[t, 0])
        cy = _class_centroid_axis(ys, s[t, 1])
        cz = _class_centroid_axis(zs, s[t, 2])
        b = recipe.body_fn(
            np.broadcast_to(cx[:, None, None], (nx, ny, nz)).ravel(),
            np.broadcast_to(cy[None, :, None], (nx, ny, nz)).ravel(),
            np.broadcast_to(cz[None, None, :], (nx, ny, nz)).ravel())
        body6[t] = np.asarray(b, np.int8).reshape(nx, ny, nz)

    # used nodes: corners of kept tets (24 shifted ORs)
    used = np.zeros((X, Y, Z), bool)
    for t in range(6):
        kept = body6[t] > 0
        for dx, dy, dz in _KUHN[t]:
            used[dx:dx + nx, dy:dy + ny, dz:dz + nz] |= kept

    # deformed node coordinates (deform_fn is pointwise, so the full
    # grid gives the same values as the compacted mesh nodes)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    knot = np.stack([gx, gy, gz])                        # (3, X, Y, Z)
    if recipe.deform_fn is not None:
        nodes = knot.reshape(3, -1).T.copy()
        nodes = recipe.deform_fn(nodes)
        coords = np.ascontiguousarray(nodes.T).reshape(3, X, Y, Z)
    else:
        coords = knot
    coords_dev = coords - knot

    # electrode faces on the extreme z-planes
    act_t, ret_t, area_t, top_tris = _electrode_faces_on_plane(
        _TOP_FACES, xs, ys, zs, coords, body6, recipe.bcid_fn,
        Z - 1, +1.0)
    act_b, ret_b, area_b, bot_tris = _electrode_faces_on_plane(
        _BOT_FACES, xs, ys, zs, coords, body6, recipe.bcid_fn,
        0, -1.0)

    area_active = float(area_t[act_t].sum() + area_b[act_b].sum())
    area_return = float(area_t[ret_t].sum() + area_b[ret_b].sum())

    def scatter_nodes(mask2, tris, node_k, vals=None, out=None,
                      dtype=bool):
        """Accumulate per-face values (or membership) to corner nodes on
        one node plane."""
        if out is None:
            out = np.zeros((X, Y, Z), dtype)
        for fi, tri in enumerate(tris):
            m = mask2[fi]
            for v in range(3):
                sl = (slice(tri[v, 0], tri[v, 0] + nx),
                      slice(tri[v, 1], tri[v, 1] + ny), node_k)
                if vals is None:
                    out[sl] |= m
                else:
                    out[sl] += np.where(m, vals[fi], 0.0)
        return out

    act_nodes = scatter_nodes(act_t, top_tris, Z - 1)
    act_nodes = scatter_nodes(act_b, bot_tris, 0, out=act_nodes)
    ret_nodes = scatter_nodes(ret_t, top_tris, Z - 1)
    ret_nodes = scatter_nodes(ret_b, bot_tris, 0, out=ret_nodes)

    dirichlet = np.zeros((X, Y, Z))
    b_neumann = np.zeros((X, Y, Z))
    free = used.copy()
    jn = 0.0
    if mode == "voltage":
        free &= ~(act_nodes | ret_nodes)
        dirichlet[act_nodes] = active_V
    elif mode == "current":
        if area_active <= 0:
            raise ValueError("current mode requires a nonzero active "
                             "electrode patch")
        # Jn from the true mesh area so the load integrates to I exactly
        jn = injected_current_A / area_active
        b_neumann = scatter_nodes(act_t, top_tris, Z - 1,
                                  vals=jn * area_t / 3.0,
                                  dtype=np.float64)
        b_neumann = scatter_nodes(act_b, bot_tris, 0,
                                  vals=jn * area_b / 3.0, out=b_neumann,
                                  dtype=np.float64)
        got = b_neumann.sum()
        if abs(got - injected_current_A) > 1e-9 * max(
                abs(injected_current_A), 1.0):
            raise ValueError(f"Neumann load integrates to {got}, "
                             f"expected {injected_current_A}")
        free &= ~ret_nodes
    else:
        raise ValueError(f"unknown mode {mode!r}")

    n_bodies = max(sigma_by_body)
    sigma_table = np.zeros(n_bodies + 1)
    for b, sg in sigma_by_body.items():
        sigma_table[b] = sg

    return LatticeSpec(
        axes=(xs, ys, zs),
        coords_dev=coords_dev,
        body6=body6,
        n_bodies=n_bodies,
        used=used,
        free=free,
        dirichlet=dirichlet,
        b_neumann=b_neumann,
        grid_index=np.flatnonzero(used.ravel()),
        sigma_table=sigma_table,
        mode=mode,
        jn=float(jn),
        area_active=area_active,
        area_return=area_return,
    )
