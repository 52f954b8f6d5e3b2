"""Conforming local mesh refinement by Maubach bisection (numpy twin of
pelvistim_fem_tpu/mesh/refine.py; the same marks give bit-identical
meshes).

Each tet is an ORDERED vertex tuple (x0, x1, x2, x3) with level l in
{0, 1, 2}; its refinement edge is x0-x_k with k = 3 - l.  Bisection at
the edge midpoint z gives
    child1 = (x0, ..., x_{k-1}, z, x_{k+1}, ..., x3)   (x_k -> z)
    child2 = (x1, ..., x_k, z, x_{k+1}, ..., x3)
both of level (l + 1) mod 3.  Kuhn lattice tets in path order (corner
offsets sorted by coordinate sum) are a valid initial structure, and the
closure (bisecting every tet with a hanging node on one of its six
edges) ends in a conforming mesh (Maubach 1995, Traxler 1997).

Host numpy throughout.  The boundary is classified again by the recipe's
bcid_fn on the undeformed refined nodes; body ids are inherited from the
parents; recipe.deform_fn is applied to the final nodes only.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from pelvistim_fem_tpu_torch.mesh.boundary import extract_boundary
from pelvistim_fem_tpu_torch.mesh.core import TetMesh, compact
from pelvistim_fem_tpu_torch.mesh.generate import (_KUHN, LatticeRecipe,
                                                   _lattice_tet_centroids,
                                                   lattice_tets)

# per-Kuhn-class permutation into PATH order (corner offset sums are
# 0, 1, 2, 3 along the path, distinct per class)
_PATH_PERM = np.stack([np.argsort(_KUHN[t].sum(axis=1), kind="stable")
                       for t in range(6)])


def _encode(a, b, shift=32):
    """Order-free edge key: (min << 32) | max (node ids < 2^32)."""
    lo = np.minimum(a, b).astype(np.int64)
    hi = np.maximum(a, b).astype(np.int64)
    return (lo << shift) | hi


@dataclasses.dataclass
class BisectionMesh:
    """Growable Maubach-ordered tet soup and the recipe that classifies
    its boundary.  nodes are UNDEFORMED lattice coordinates; mesh()
    applies recipe.deform_fn last."""
    nodes: np.ndarray        # (N, 3) f64, undeformed
    tets: np.ndarray         # (M, 4) i64, Maubach path order
    levels: np.ndarray       # (M,) i8 in {0, 1, 2}
    tet_body: np.ndarray     # (M,) i32
    recipe: LatticeRecipe
    edge_keys: np.ndarray    # sorted i64 keys of ever-bisected edges
    edge_mids: np.ndarray    # midpoint node id per key

    @classmethod
    def from_recipe(cls, recipe: LatticeRecipe) -> "BisectionMesh":
        xs = np.asarray(recipe.xs, float)
        ys = np.asarray(recipe.ys, float)
        zs = np.asarray(recipe.zs, float)
        nodes, tets = lattice_tets(xs, ys, zs)
        cen = _lattice_tet_centroids(xs, ys, zs)
        body = np.asarray(recipe.body_fn(cen[:, 0], cen[:, 1],
                                         cen[:, 2]), np.int32)
        keep = np.flatnonzero(body > 0)
        tets = tets[keep].astype(np.int64)
        body = body[keep]
        # lattice_tets emits cell-major, class-minor (m = cell*6 + t):
        # reorder each tet's vertices into the Kuhn PATH order
        cls_of = (keep % 6).astype(np.int64)
        tets = np.take_along_axis(tets, _PATH_PERM[cls_of], axis=1)
        return cls(nodes=np.asarray(nodes, float), tets=tets,
                   levels=np.zeros(len(tets), np.int8),
                   tet_body=body, recipe=recipe,
                   edge_keys=np.empty(0, np.int64),
                   edge_mids=np.empty(0, np.int64))

    @property
    def n_tets(self) -> int:
        return int(self.tets.shape[0])

    def refine(self, marked) -> "BisectionMesh":
        """Bisect the marked tets and close conformingly.  Returns a new
        BisectionMesh; self is unchanged."""
        nodes = self.nodes
        tets = self.tets.copy()
        levels = self.levels.copy()
        body = self.tet_body.copy()
        ekeys = self.edge_keys
        emids = self.edge_mids
        queue = np.flatnonzero(np.asarray(marked, bool))
        new_chunks = [nodes]
        n_nodes = len(nodes)

        for _ in range(200):                       # closure rounds
            if queue.size == 0:
                break
            q = queue
            k = (3 - levels[q]).astype(np.int64)   # refinement edge col
            keys = _encode(tets[q, 0], tets[q, k])
            # existing midpoints first
            mid = np.full(q.size, -1, np.int64)
            if ekeys.size:
                pos = np.clip(np.searchsorted(ekeys, keys), 0,
                              ekeys.size - 1)
                hit = ekeys[pos] == keys
                mid[hit] = emids[pos[hit]]
            # new midpoints for the rest (deduplicated within the round)
            need = mid < 0
            if need.any():
                uk, inv = np.unique(keys[need], return_inverse=True)
                ids = n_nodes + np.arange(uk.size)
                lo = (uk >> 32).astype(np.int64)
                hi = (uk & 0xFFFFFFFF).astype(np.int64)
                allnodes = (new_chunks[0] if len(new_chunks) == 1
                            else np.concatenate(new_chunks))
                new_chunks = [allnodes,
                              0.5 * (allnodes[lo] + allnodes[hi])]
                n_nodes += uk.size
                mid[need] = ids[inv]
                ekeys = np.concatenate([ekeys, uk])
                emids = np.concatenate([emids, ids])
                order = np.argsort(ekeys, kind="stable")
                ekeys, emids = ekeys[order], emids[order]

            # children: child1 replaces x_k by z in place, child2 =
            # (x1..x_k, z, x_{k+1}..x3) is appended
            parent = tets[q].copy()
            lvl_new = ((levels[q].astype(np.int64) + 1) % 3).astype(
                np.int8)
            c2 = np.empty_like(parent)
            for kk, cols in ((3, (1, 2, 3, -1)),
                             (2, (1, 2, -1, 3)),
                             (1, (1, -1, 2, 3))):
                m = k == kk
                if not m.any():
                    continue
                src = parent[m]
                zz = mid[m]
                out = np.empty_like(src)
                for j, c in enumerate(cols):
                    out[:, j] = zz if c == -1 else src[:, c]
                c2[m] = out
                tets[q[m], kk] = zz
            levels[q] = lvl_new
            tets = np.concatenate([tets, c2])
            levels = np.concatenate([levels, lvl_new])
            body = np.concatenate([body, body[q]])

            # closure: every tet with a hanging node on one of its edges
            hang = np.zeros(len(tets), bool)
            for a, b in ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3)):
                kk = _encode(tets[:, a], tets[:, b])
                pos = np.clip(np.searchsorted(ekeys, kk), 0,
                              ekeys.size - 1)
                hang |= ekeys[pos] == kk
            queue = np.flatnonzero(hang)
        else:
            raise RuntimeError("bisection closure did not terminate")

        nodes = (new_chunks[0] if len(new_chunks) == 1
                 else np.concatenate(new_chunks))
        return BisectionMesh(nodes=nodes, tets=tets, levels=levels,
                             tet_body=body, recipe=self.recipe,
                             edge_keys=ekeys, edge_mids=emids)

    def mesh(self) -> TetMesh:
        """A TetMesh: nodes compacted, the boundary extracted and
        classified on the UNDEFORMED lattice, then deformed."""
        nodes, tets = compact(self.nodes, self.tets.astype(np.int64))
        # the children alternate orientation; extract_boundary's outward
        # rule needs positive tets, so orient a COPY (self.tets keeps the
        # bisection order, which the next refine needs)
        p = nodes[tets]
        vol6 = np.einsum("mi,mi->m", p[:, 1] - p[:, 0],
                         np.cross(p[:, 2] - p[:, 0], p[:, 3] - p[:, 0]))
        neg = vol6 < 0
        tets = tets.copy()
        t0 = tets[neg, 0].copy()
        tets[neg, 0] = tets[neg, 1]
        tets[neg, 1] = t0
        faces, parent = extract_boundary(tets.astype(np.int32))
        p = nodes[faces]
        fcen = p.mean(axis=1)
        crs = np.cross(p[:, 1] - p[:, 0], p[:, 2] - p[:, 0])
        nrm = crs / np.maximum(np.linalg.norm(crs, axis=1),
                               1e-300)[:, None]
        bcid = np.asarray(
            self.recipe.bcid_fn(fcen[:, 0], fcen[:, 1], fcen[:, 2],
                                nrm[:, 0], nrm[:, 1], nrm[:, 2]),
            np.int32)
        if self.recipe.deform_fn is not None:
            nodes = self.recipe.deform_fn(nodes)
        m = TetMesh(nodes=nodes, tets=np.asarray(tets, np.int32),
                    tet_body=self.tet_body.copy(), faces=faces,
                    face_bcid=bcid, face_parent=parent, lattice=None)
        return m.with_positive_volumes()


def mark_doerfler(eta: np.ndarray, theta: float = 0.6) -> np.ndarray:
    """Doerfler (bulk-chasing) marking: the smallest tet set carrying a
    `theta` fraction of the total squared indicator."""
    eta2 = np.asarray(eta, float) ** 2
    order = np.argsort(eta2)[::-1]
    csum = np.cumsum(eta2[order])
    n_pick = int(np.searchsorted(csum, theta * csum[-1])) + 1
    marked = np.zeros(eta2.size, bool)
    marked[order[:n_pick]] = True
    return marked
