"""Tetrahedral mesh data model and the boundary-condition and body ids
(numpy twin of pelvistim_fem_tpu/mesh/core.py; every array is
bit-identical to the JAX package's).

Arrays of a TetMesh:
  nodes      (N, 3) float64   node coordinates [m]
  tets       (M, 4) int32     node indices per tetrahedron
  tet_body   (M,)   int32     1-based body (material) id per tet
  faces      (B, 3) int32     boundary (external) triangle faces
  face_bcid  (B,)   int32     boundary-condition id per face
  face_parent(B,)   int32     index of the tet owning each boundary face
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Boundary-condition ids: 1 = active electrode, 2 = return electrode,
# 3 = insulated.
BC_ACTIVE = 1
BC_RETURN = 2
BC_INSULATED = 3

# Body (material) ids of the layered models.
BODY_MUSCLE = 1
BODY_FAT = 2
BODY_SKIN = 3
BODY_CONTACT_ACTIVE = 4
BODY_CONTACT_RETURN = 5
# single-tissue box models
BODY_TISSUE = 1


@dataclasses.dataclass
class LatticeInfo:
    """Provenance of a mesh generated from a tensor-product lattice.

    grid_shape: (nx+1, ny+1, nz+1) lattice node counts.
    grid_index: (N,) linear lattice index of each (compacted) mesh node,
                x-major: lin = (i*(ny+1) + j)*(nz+1) + k.
    axes:       the (xs, ys, zs) knot vectors.
    """
    grid_shape: tuple
    grid_index: np.ndarray
    axes: tuple


@dataclasses.dataclass
class TetMesh:
    """Host-side tetrahedral mesh (numpy)."""

    nodes: np.ndarray        # (N, 3) f64
    tets: np.ndarray         # (M, 4) i32
    tet_body: np.ndarray     # (M,)   i32
    faces: np.ndarray        # (B, 3) i32
    face_bcid: np.ndarray    # (B,)   i32
    face_parent: np.ndarray  # (B,)   i32
    lattice: LatticeInfo | None = None
    _geom: tuple | None = dataclasses.field(default=None, repr=False,
                                            compare=False)
    _face_geom: tuple | None = dataclasses.field(default=None, repr=False,
                                                 compare=False)

    def geometry(self):
        """Cached (grads (M, 4, 3), vol (M,)) P1 element geometry."""
        if self._geom is None:
            from pelvistim_fem_tpu_torch.ops.assembly import \
                element_gradients
            self._geom = element_gradients(self.nodes, self.tets)
        return self._geom

    @property
    def n_nodes(self) -> int:
        return int(self.nodes.shape[0])

    @property
    def n_tets(self) -> int:
        return int(self.tets.shape[0])

    @property
    def n_faces(self) -> int:
        return int(self.faces.shape[0])

    def validate(self) -> None:
        """Structural sanity checks (cheap; raises AssertionError)."""
        assert self.nodes.ndim == 2 and self.nodes.shape[1] == 3
        assert self.tets.ndim == 2 and self.tets.shape[1] == 4
        assert self.tet_body.shape == (self.n_tets,)
        assert self.faces.ndim == 2 and self.faces.shape[1] == 3
        assert self.face_bcid.shape == (self.n_faces,)
        assert self.face_parent.shape == (self.n_faces,)
        assert self.tets.min() >= 0 and self.tets.max() < self.n_nodes
        if self.n_faces:
            assert self.faces.min() >= 0 and self.faces.max() < self.n_nodes
            assert self.face_parent.min() >= 0
            assert self.face_parent.max() < self.n_tets
        assert (self.geometry()[1] > 0).all(), \
            "all tets must have positive volume"

    def with_positive_volumes(self) -> "TetMesh":
        """Copy with the node order flipped on negative-volume tets."""
        vols = tet_volumes(self.nodes, self.tets)
        tets = self.tets.copy()
        neg = vols < 0
        tets[neg, 2], tets[neg, 3] = self.tets[neg, 3], self.tets[neg, 2]
        return dataclasses.replace(self, tets=tets, _geom=None,
                                   _face_geom=None)

    def face_areas_normals(self):
        """Cached areas and OUTWARD unit normals of the boundary faces
        (orientation fixed against the parent tet's centroid)."""
        if self._face_geom is not None:
            return self._face_geom
        p = self.nodes[self.faces]                       # (B, 3, 3)
        cross = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        areas = 0.5 * np.linalg.norm(cross, axis=1)
        normals = cross / np.maximum(np.linalg.norm(cross, axis=1),
                                     1e-300)[:, None]
        face_cen = p.mean(axis=1)
        tet_cen = self.nodes[self.tets[self.face_parent]].mean(axis=1)
        outward = ((face_cen - tet_cen) * normals).sum(axis=1)
        normals = np.where(outward[:, None] >= 0, normals, -normals)
        self._face_geom = (areas, normals)
        return areas, normals


def tet_volumes(nodes: np.ndarray, tets: np.ndarray) -> np.ndarray:
    """Signed tet volumes det([x1-x0, x2-x0, x3-x0]) / 6."""
    x = nodes[tets]                                       # (M, 4, 3)
    e1 = x[:, 1] - x[:, 0]
    e2 = x[:, 2] - x[:, 0]
    e3 = x[:, 3] - x[:, 0]
    return np.einsum("md,md->m", e1, np.cross(e2, e3)) / 6.0


def compact(nodes: np.ndarray, tets: np.ndarray, *extra_index_arrays):
    """Drop unreferenced nodes and renumber (ascending, so grid order is
    kept).  Returns (nodes, tets, remapped_extras...)."""
    mask = np.zeros(nodes.shape[0], dtype=bool)
    mask[tets.ravel()] = True
    used = np.flatnonzero(mask)
    remap = -np.ones(nodes.shape[0], dtype=np.int32)
    remap[used] = np.arange(used.size, dtype=np.int32)
    out = [nodes[used], remap[tets].astype(np.int32)]
    for arr in extra_index_arrays:
        out.append(remap[arr].astype(np.int32))
    return tuple(out)


def tet_quality(nodes: np.ndarray, tets: np.ndarray):
    """Per-tet shape quality for mesh inspection (imported meshes can
    carry slivers that wreck an iterative solver's conditioning).

    Returns dict with:
      radius_ratio  (M,)  3 r_in / r_circ in (0, 1]; 1 = regular tet
      min_dihedral  (M,)  smallest dihedral angle [deg] (regular: 70.53;
                          Kuhn lattice tets: 45)
    Exactly degenerate tets (coplanar or duplicate nodes) report 0.
    """
    p = nodes[tets]                                  # (M, 4, 3)
    v = p[:, 1:] - p[:, :1]                          # (M, 3, 3)
    vol = np.abs(np.einsum("mi,mi->m", v[:, 0],
                           np.cross(v[:, 1], v[:, 2]))) / 6.0

    # inradius: 3 V / total face area
    faces = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    fa = []
    normals = []
    for a, b, c in faces:
        n = np.cross(p[:, b] - p[:, a], p[:, c] - p[:, a])
        ln = np.linalg.norm(n, axis=1)
        fa.append(0.5 * ln)
        normals.append(n / np.maximum(ln, 1e-300)[:, None])
    area_sum = np.sum(fa, axis=0)
    r_in = 3.0 * vol / np.maximum(area_sum, 1e-300)

    # circumradius from the circumcentre system
    # 2 (p_i - p_0) . c = |p_i|^2 - |p_0|^2; degenerate tets get the
    # identity so the batched solve cannot raise
    A = 2.0 * v                                      # (M, 3, 3)
    det = np.einsum("mi,mi->m", A[:, 0], np.cross(A[:, 1], A[:, 2]))
    edge = np.linalg.norm(v, axis=2).max(axis=1)
    ok = np.abs(det) > 1e-14 * np.maximum(edge, 1e-300) ** 3
    A_safe = np.where(ok[:, None, None], A,
                      np.eye(3)[None, :, :])
    rhs = (np.einsum("mij,mij->mi", p[:, 1:], p[:, 1:])
           - np.einsum("mj,mj->m", p[:, 0], p[:, 0])[:, None])
    c = np.linalg.solve(A_safe, rhs[..., None])[..., 0]
    r_circ = np.linalg.norm(c - p[:, 0], axis=1)
    radius_ratio = np.where(ok, 3.0 * r_in / np.maximum(r_circ, 1e-300),
                            0.0)

    # dihedral angles: the interior angle between two faces is pi minus
    # the angle between their outward normals (oriented against the
    # centroid first)
    cen = p.mean(axis=1)
    for k, (a, b, cc) in enumerate(faces):
        fc = (p[:, a] + p[:, b] + p[:, cc]) / 3.0
        sgn = np.sign(np.einsum("mi,mi->m", normals[k], fc - cen))
        normals[k] = normals[k] * np.where(sgn == 0, 1.0, sgn)[:, None]
    min_dih = np.full(len(tets), np.pi)
    for i in range(4):
        for j in range(i + 1, 4):
            cosd = -np.einsum("mi,mi->m", normals[i], normals[j])
            ang = np.arccos(np.clip(cosd, -1.0, 1.0))
            min_dih = np.minimum(min_dih, ang)
    return {"radius_ratio": radius_ratio,
            "min_dihedral": np.where(ok, np.degrees(min_dih), 0.0)}
