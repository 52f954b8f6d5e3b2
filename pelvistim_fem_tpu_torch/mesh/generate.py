"""Structured lattice meshes (numpy twin of
pelvistim_fem_tpu/mesh/generate.py; every array is bit-identical to the
JAX package's).

Every geometry of the layered workloads is a (possibly deformed)
extrusion of a 2-D outline: a tensor-product hex lattice split into 6
Kuhn tets per cell, with graded knot spacing.  A recipe is consumed two
ways: mesh/spec.build_lattice_spec turns it into the compact grid form
that the stencil solvers assemble from, and `LatticeRecipe.mesh()`
materialises the TetMesh that the element Case and the metrics use.

Kuhn subdivision: each hex cell is split into the 6 tets
{v(0), v(e_p0), v(e_p0 + e_p1), v(1,1,1)} over permutations p of (x,y,z).
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np

from pelvistim_fem_tpu_torch.mesh import core
from pelvistim_fem_tpu_torch.mesh.boundary import extract_boundary
from pelvistim_fem_tpu_torch.mesh.core import (BC_ACTIVE, BC_INSULATED,
                                               BC_RETURN, TetMesh, compact)

# The 6 Kuhn tets of the unit cube as corner offsets (6, 4, 3).
_KUHN = []
for perm in itertools.permutations(range(3)):
    c0 = np.zeros(3, dtype=np.int64)
    c1 = c0.copy(); c1[perm[0]] = 1
    c2 = c1.copy(); c2[perm[1]] = 1
    c3 = np.ones(3, dtype=np.int64)
    # odd permutations give negatively oriented tets: swap the last two
    # vertices so every tet is positive on a grid with positive spacing
    parity = sum(1 for i in range(3) for j in range(i + 1, 3)
                 if perm[i] > perm[j]) % 2
    tet = np.stack([c0, c1, c2, c3])
    if parity == 1:
        tet = tet[[0, 1, 3, 2]]
    _KUHN.append(tet)
_KUHN = np.stack(_KUHN)


def lattice_tets(xs: np.ndarray, ys: np.ndarray, zs: np.ndarray):
    """Nodes and Kuhn tets of the tensor grid xs x ys x zs: (nodes (N, 3)
    f64 x-major, tets (M, 4) i32 with positive volumes; tet r is class
    r % 6 of cell r // 6)."""
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    X, Y, Z = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    ii, jj, kk = np.meshgrid(np.arange(nx), np.arange(ny), np.arange(nz),
                             indexing="ij")
    ii, jj, kk = ii.ravel(), jj.ravel(), kk.ravel()   # (C,) cell origins

    tets = np.empty((ii.size * 6, 4), dtype=np.int64)
    for t in range(6):
        for v in range(4):
            dx, dy, dz = _KUHN[t, v]
            tets[t::6, v] = nid(ii + dx, jj + dy, kk + dz)
    return nodes, tets.astype(np.int32)


def _lattice_tet_centroids(xs, ys, zs):
    """Centroids of every Kuhn tet without gathering node coordinates:
    class t's per-axis centroid is ((4 - s) * knot[i] + s * knot[i+1]) / 4
    with s its count of +1 offsets on that axis.  (M, 3) in lattice_tets
    order."""
    s = _KUHN.sum(axis=1).astype(np.float64)          # (6, 3)
    outs = []
    for axis, arr in ((0, xs), (1, ys), (2, zs)):
        lo = np.asarray(arr[:-1], np.float64)
        hi = np.asarray(arr[1:], np.float64)
        outs.append((lo[:, None] * (4.0 - s[None, :, axis])
                     + hi[:, None] * s[None, :, axis]) / 4.0)
    cx, cy, cz = outs
    nx, ny, nz = len(xs) - 1, len(ys) - 1, len(zs) - 1
    cen = np.empty((nx * ny * nz * 6, 3))
    cen[:, 0] = np.broadcast_to(cx[:, None, None, :],
                                (nx, ny, nz, 6)).reshape(-1)
    cen[:, 1] = np.broadcast_to(cy[None, :, None, :],
                                (nx, ny, nz, 6)).reshape(-1)
    cen[:, 2] = np.broadcast_to(cz[None, None, :, :],
                                (nx, ny, nz, 6)).reshape(-1)
    return cen


@dataclasses.dataclass
class LatticeRecipe:
    """Declarative lattice spec: knot axes + classifier callbacks.

    body_fn(cx, cy, cz) -> int body ids from tet centroids (0 = carved);
    bcid_fn(fx, fy, fz, nx, ny, nz) -> BC ids from boundary-face
    centroids and outward normals; deform_fn(nodes) -> nodes, a pointwise
    coordinate map applied after classification.  Electrode BC faces must
    lie on the extreme z-planes of the lattice."""
    xs: np.ndarray
    ys: np.ndarray
    zs: np.ndarray
    body_fn: object
    bcid_fn: object
    deform_fn: object = None

    def mesh(self) -> TetMesh:
        return build_mesh_from_lattice(self.xs, self.ys, self.zs,
                                       self.body_fn, self.bcid_fn,
                                       self.deform_fn)


def build_mesh_from_lattice(xs, ys, zs, body_fn, bcid_fn,
                            deform_fn=None) -> TetMesh:
    """Lattice -> TetMesh: body ids from undeformed tet centroids (0
    drops the tet), BC ids from undeformed boundary-face centroids and
    normals, then the optional pointwise deformation (and a re-orientation
    of any tet it inverted)."""
    xs = np.asarray(xs, float)
    ys = np.asarray(ys, float)
    zs = np.asarray(zs, float)
    nodes, tets = lattice_tets(xs, ys, zs)
    cen = _lattice_tet_centroids(xs, ys, zs)
    body = np.asarray(body_fn(cen[:, 0], cen[:, 1], cen[:, 2]),
                      dtype=np.int32)
    keep = body > 0
    tets, body = tets[keep], body[keep]
    # compact() keeps grid order: `used` is the lattice index of each
    # surviving node
    used = np.unique(tets)
    nodes, tets = compact(nodes, tets)
    lattice = core.LatticeInfo(
        grid_shape=(len(xs), len(ys), len(zs)),
        grid_index=used.astype(np.int64),
        axes=(xs, ys, zs),
    )

    faces, parent = extract_boundary(tets)
    p = nodes[faces]
    fcen = p.mean(axis=1)
    crs = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
    nrm = crs / np.maximum(np.linalg.norm(crs, axis=1), 1e-300)[:, None]
    bcid = np.asarray(
        bcid_fn(fcen[:, 0], fcen[:, 1], fcen[:, 2],
                nrm[:, 0], nrm[:, 1], nrm[:, 2]),
        dtype=np.int32)

    if deform_fn is not None:
        nodes = deform_fn(nodes)

    mesh = TetMesh(nodes=nodes, tets=tets, tet_body=body, faces=faces,
                   face_bcid=bcid, face_parent=parent, lattice=lattice)
    if deform_fn is not None:
        mesh = mesh.with_positive_volumes()
    return mesh


def box_recipe(Lx: float, Ly: float, Lz: float, h: float) -> LatticeRecipe:
    """Uniform box (step01): top face BC 1 (active), bottom BC 2
    (return), sides BC 3 (insulated), one tissue body."""
    from pelvistim_fem_tpu_torch.mesh.grading import uniform_axis
    xs = uniform_axis(0, Lx, h)
    ys = uniform_axis(0, Ly, h)
    zs = uniform_axis(0, Lz, h)
    eps = 1e-9 * max(Lx, Ly, Lz)

    def body_fn(cx, cy, cz):
        return np.full(cx.shape, core.BODY_TISSUE, np.int32)

    def bcid_fn(fx, fy, fz, nx, ny, nz):
        out = np.full(fx.shape, BC_INSULATED, np.int32)
        out[(nz > 0.5) & (np.abs(fz - Lz) < h * 1e-3 + eps)] = BC_ACTIVE
        out[(nz < -0.5) & (np.abs(fz) < h * 1e-3 + eps)] = BC_RETURN
        return out

    return LatticeRecipe(xs, ys, zs, body_fn, bcid_fn)


def box_mesh(Lx: float, Ly: float, Lz: float, h: float) -> TetMesh:
    """TetMesh of box_recipe(Lx, Ly, Lz, h)."""
    return box_recipe(Lx, Ly, Lz, h).mesh()


def _footprint_mask(x, y, cx, cy, r, shape):
    """Point-in-electrode-footprint predicate (circle, or square of
    half-side r)."""
    if shape == "square":
        return (np.abs(x - cx) < r) & (np.abs(y - cy) < r)
    return (x - cx) ** 2 + (y - cy) ** 2 < r * r


def layered_slab_recipe(
    Lx: float,
    Ly: float,
    Lz: float,
    *,
    layers,                      # [(body_id, thickness, h_z)] bottom -> top
    electrodes,                  # [(cx, cy, radius)] — [active, return]
    elec_shape: str = "circle",
    contact_t: float = 0.0,      # contact layer thickness (0 = none)
    contact_h_z: float = None,
    h_fine: float = 0.0015,      # xy spacing under electrodes
    h_coarse: float = 0.003,     # xy spacing elsewhere
    rim_refine: float = 0.0,     # >1: electrode-rim bands at h_fine/rim_refine
    rim_band_w: float = 0.0,     # band half-width override [m]
    cross_section: str = "rect",
    ankle_z_top_fn=None,         # (x, y) -> z_top for "ankle" deformation
    outline_polygon=None,        # [(x, y)] for "ankle" cross-section carve
    explicit_zs=None,            # shared z-knot override
) -> LatticeRecipe:
    """Layered tissue slab with optional per-electrode contact volumes.

    Bodies: layer ids bottom -> top (1 muscle, 2 fat, 3 skin), plus
    contact bodies 4 (active) / 5 (return) when contact_t > 0.  BC faces:
    the top of each contact volume (or the skin-top footprint when
    contact_t == 0) is BC 1 / BC 2; everything else is insulated.
    """
    from pelvistim_fem_tpu_torch.mesh.grading import (graded_axis,
                                                      layered_z_axis)

    (e1x, e1y, r1), (e2x, e2y, r2) = electrodes
    pad = 1.15  # refine slightly past the footprint edge
    fine_x = [(e1x - r1 * pad, e1x + r1 * pad),
              (e2x - r2 * pad, e2x + r2 * pad)]
    fine_y = [(e1y - r1 * pad, e1y + r1 * pad),
              (e2y - r2 * pad, e2y + r2 * pad)]
    if rim_refine > 1.0:
        # extra-fine bands of width w around every axis coordinate the
        # rim crosses, at spacing h_fine / rim_refine
        h_rim = h_fine / rim_refine
        w = rim_band_w if rim_band_w > 0 else max(3 * h_rim, 0.12 * r1)
        for (cx, cy, r) in ((e1x, e1y, r1), (e2x, e2y, r2)):
            for frac in (1.0, 0.7071):
                for s in (-1.0, 1.0):
                    fine_x.append((cx + s * frac * r - w,
                                   cx + s * frac * r + w, h_rim))
                    fine_y.append((cy + s * frac * r - w,
                                   cy + s * frac * r + w, h_rim))
    xs = graded_axis(0, Lx, fine_x, h_fine, h_coarse)
    ys = graded_axis(0, Ly, fine_y, h_fine, h_coarse)

    # exact footprint extents as knots (anchors for the rim snapping)
    def _merge_knots(base, extra, tol):
        out = np.asarray(sorted(set(np.clip(extra, base[0], base[-1]))
                                | set(base.tolist())))
        keep = np.ones(len(out), bool)
        for v in extra:
            close = (np.abs(out - v) < tol) & (np.abs(out - v) > 0)
            keep &= ~close
        keep[0] = keep[-1] = True
        return out[keep]

    # the merge tolerance (0.5h) exceeds the rim-snap clamp (0.35h)
    extra_x = [e1x - r1, e1x, e1x + r1, e2x - r2, e2x, e2x + r2]
    extra_y = [e1y - r1, e1y, e1y + r1, e2y - r2, e2y, e2y + r2]
    xs = _merge_knots(xs, extra_x, h_fine * 0.5)
    ys = _merge_knots(ys, extra_y, h_fine * 0.5)

    interfaces = [0.0]
    hs = []
    for _body, t, hz in layers:
        interfaces.append(interfaces[-1] + t)
        hs.append(hz)
    if abs(interfaces[-1] - Lz) > 1e-9:
        raise ValueError(f"layer thicknesses sum to {interfaces[-1]}, "
                         f"expected Lz={Lz}")
    if contact_t > 0:
        interfaces.append(Lz + contact_t)
        hs.append(contact_h_z or contact_t)
    zs = (np.asarray(explicit_zs, float) if explicit_zs is not None
          else layered_z_axis(interfaces, hs))
    if explicit_zs is not None:
        for z in interfaces:
            if np.min(np.abs(zs - z)) > 1e-12:
                raise ValueError(f"explicit_zs must contain the layer "
                                 f"interface z={z}")

    layer_tops = np.asarray(interfaces[1:1 + len(layers)])
    layer_ids = np.asarray([b for b, _, _ in layers], np.int32)

    in_poly = None
    if cross_section == "ankle" and outline_polygon is not None:
        poly = np.asarray(outline_polygon, float)

        def in_poly(px, py):
            # even-odd ray casting, vectorized
            inside = np.zeros(px.shape, dtype=bool)
            n = len(poly)
            for i in range(n):
                x1, y1 = poly[i]
                x2, y2 = poly[(i + 1) % n]
                cond = ((y1 > py) != (y2 > py))
                xint = (x2 - x1) * (py - y1) / (y2 - y1 + 1e-300) + x1
                inside ^= cond & (px < xint)
            return inside

    def body_fn(cx, cy, cz):
        out = np.zeros(cx.shape, np.int32)
        in_layer = cz < Lz
        idx = np.searchsorted(layer_tops, np.clip(cz, 0, Lz), side="right")
        idx = np.clip(idx, 0, len(layer_ids) - 1)
        out[in_layer] = layer_ids[idx[in_layer]]
        if contact_t > 0:
            above = cz >= Lz
            f1 = _footprint_mask(cx, cy, e1x, e1y, r1, elec_shape)
            f2 = _footprint_mask(cx, cy, e2x, e2y, r2, elec_shape)
            out[above & f1] = core.BODY_CONTACT_ACTIVE
            out[above & f2] = core.BODY_CONTACT_RETURN
            out[above & ~(f1 | f2)] = 0       # no material outside footprints
        if in_poly is not None:
            out[~in_poly(cx, cy)] = 0
        return out

    z_bc = Lz + contact_t if contact_t > 0 else Lz
    z_tol = max(hs[-1] * 1e-3, 1e-9)

    def bcid_fn(fx, fy, fz, nx, ny, nz):
        out = np.full(fx.shape, BC_INSULATED, np.int32)
        top = (nz > 0.5) & (np.abs(fz - z_bc) < z_tol)
        f1 = _footprint_mask(fx, fy, e1x, e1y, r1, elec_shape)
        f2 = _footprint_mask(fx, fy, e2x, e2y, r2, elec_shape)
        out[top & f1] = BC_ACTIVE
        out[top & f2] = BC_RETURN
        return out

    # Rim snapping (circular electrodes): node columns just inside a rim
    # move radially onto the exact circle, displacement clamped to
    # 0.35 * h so no cell inverts; the band follows the rim refinement.
    h_snap = h_fine / rim_refine if rim_refine > 1.0 else h_fine

    def _snap_rims(nodes):
        if elec_shape != "circle":
            return nodes
        nodes = nodes.copy()
        for cx, cy, r in ((e1x, e1y, r1), (e2x, e2y, r2)):
            dx = nodes[:, 0] - cx
            dy = nodes[:, 1] - cy
            d = np.hypot(dx, dy)
            # one-sided outward snap: snapping from both sides would land
            # radially adjacent columns on one radius
            band = (d < r) & (d > r - 0.5 * h_snap) & (d > 1e-12)
            disp = np.minimum(r - d[band], 0.35 * h_snap)
            scale = (d[band] + disp) / d[band]
            nodes[band, 0] = cx + dx[band] * scale
            nodes[band, 1] = cy + dy[band] * scale
        return nodes

    deform_fn = _snap_rims
    if cross_section == "ankle" and ankle_z_top_fn is not None:
        t_top_layer = layers[-1][1]   # skin thickness
        z0_skin = Lz - t_top_layer

        def deform_fn(nodes):
            # rim snap, then the nodal z-deformation: skin bottom fixed,
            # skin top follows z_top(x, y), contact nodes shift rigidly
            nodes = _snap_rims(nodes)
            z = nodes[:, 2]
            m = z > z0_skin - 1e-9
            t = np.clip((z[m] - z0_skin) / t_top_layer, 0.0, 1.0)
            z_target = ankle_z_top_fn(nodes[m, 0], nodes[m, 1])
            nodes[m, 2] = z[m] + (z_target - Lz) * t
            return nodes

    return LatticeRecipe(xs, ys, zs, body_fn, bcid_fn, deform_fn)


def layered_slab_mesh(Lx: float, Ly: float, Lz: float, **kw) -> TetMesh:
    """TetMesh of layered_slab_recipe(Lx, Ly, Lz, **kw)."""
    return layered_slab_recipe(Lx, Ly, Lz, **kw).mesh()
