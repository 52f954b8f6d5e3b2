"""Boundary (external face) extraction from tet connectivity (numpy twin
of pelvistim_fem_tpu/mesh/boundary.py).

An external face is a triangle that appears in exactly one tetrahedron;
faces are found by a vectorized sort/group pass and come out in
key-sorted order.
"""

from __future__ import annotations

import numpy as np

# Local faces of a positively oriented tet, ordered so the right-hand-rule
# normal points OUT of the tet.
TET_FACES = np.array([
    [1, 2, 3],
    [0, 3, 2],
    [0, 1, 3],
    [0, 2, 1],
], dtype=np.int32)


def classify_flat_extremes(nodes, faces, z_tol_frac: float = 1e-3):
    """Classify boundary faces as top (1) / bottom (2) / side (3): a face
    is top when all its nodes lie within tolerance of zmax.  Returns
    (B,) bcids."""
    z = nodes[:, 2]
    zmin, zmax = z.min(), z.max()
    tol = (zmax - zmin) * z_tol_frac
    fz = z[faces]
    out = np.full(faces.shape[0], 3, np.int32)
    out[(fz > zmax - tol).all(axis=1)] = 1
    out[(fz < zmin + tol).all(axis=1)] = 2
    return out


def detect_electrode_bcids(mesh, e1_pos, e2_pos, elec_r,
                           z_e1_top=None, z_e2_top=None):
    """Which existing bcids are the active / return electrodes of a mesh
    with arbitrary boundary numbering, and their true mesh areas: among
    boundary patches near each electrode's (x, y), the one with the
    highest z centroid (contact top over skin interface), tie-broken by
    xy distance.  Returns (bcid_active, bcid_return, area_active,
    area_return)."""
    areas, _ = mesh.face_areas_normals()
    cen = mesh.nodes[mesh.faces].mean(axis=1)
    out = []
    taken = None
    for pos, z_top in ((np.asarray(e1_pos[:2]), z_e1_top),
                       (np.asarray(e2_pos[:2]), z_e2_top)):
        best, best_score = None, None
        for bcid in np.unique(mesh.face_bcid):
            if bcid == taken:
                continue
            sel = mesh.face_bcid == bcid
            c = (cen[sel] * areas[sel, None]).sum(axis=0) / \
                areas[sel].sum()
            dxy = np.linalg.norm(c[:2] - pos)
            if dxy > elec_r * 2:
                continue
            score = (c[2], -dxy)
            if best is None or score > best_score:
                best, best_score = int(bcid), score
        if best is None:
            raise ValueError(f"no boundary patch near electrode at {pos}")
        out.append(best)
        taken = best
    a1 = float(areas[mesh.face_bcid == out[0]].sum())
    a2 = float(areas[mesh.face_bcid == out[1]].sum())
    return out[0], out[1], a1, a2


def extract_boundary(tets: np.ndarray):
    """Faces that belong to exactly one tet.  Returns (faces (B, 3) with
    outward orientation, parent_tet (B,)), in key-sorted order."""
    all_faces = tets[:, TET_FACES]                 # (M, 4, 3)
    flat = all_faces.reshape(-1, 3)                # (4M, 3)
    key = np.sort(flat, axis=1)
    order = np.lexsort((key[:, 2], key[:, 1], key[:, 0]))
    sk = key[order]
    if sk.shape[0] == 0:
        return (np.empty((0, 3), np.int32), np.empty((0,), np.int32))
    new_group = np.empty(sk.shape[0], dtype=bool)
    new_group[0] = True
    new_group[1:] = np.any(sk[1:] != sk[:-1], axis=1)
    group_end = np.empty_like(new_group)
    group_end[:-1] = new_group[1:]
    group_end[-1] = True
    singleton = new_group & group_end              # appears exactly once
    ext = order[singleton]
    parent = (ext // 4).astype(np.int32)
    return flat[ext].astype(np.int32), parent
