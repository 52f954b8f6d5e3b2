"""Elmer mesh DB interchange, mesh.header / nodes / elements / boundary
(numpy twin of pelvistim_fem_tpu/mesh/io_elmer.py; the writer's bytes
equal the JAX package's):

  mesh.header   : "nnodes nelems nbelems" / "ntypes" / "type count" ...
  mesh.nodes    : "id partition x y z"
  mesh.elements : "id body 504 n1 n2 n3 n4"            (504 = tet4)
  mesh.boundary : "id bcid parent1 parent2 303 n1 n2 n3"  (303 = tri3)

Reading takes meshes made by Gmsh + ElmerGrid for cross-validation;
writing lets ElmerSolver solve the lattice meshes.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pelvistim_fem_tpu_torch.mesh.boundary import TET_FACES, extract_boundary
from pelvistim_fem_tpu_torch.mesh.core import TetMesh

ELMER_TET4 = 504
ELMER_TRI3 = 303


def read_elmer_mesh(mesh_dir) -> TetMesh:
    """Parse an Elmer mesh DB directory into a TetMesh (1-based Elmer node
    ids -> 0-based).  Only tet4 volume and tri3 boundary elements are
    kept."""
    mesh_dir = Path(mesh_dir)

    ids, coords = [], []
    for line in (mesh_dir / "mesh.nodes").read_text().splitlines():
        parts = line.split()
        if len(parts) >= 5:
            ids.append(int(parts[0]))
            coords.append([float(parts[-3]), float(parts[-2]),
                           float(parts[-1])])
    ids = np.asarray(ids)
    coords = np.asarray(coords)
    # Elmer ids are 1..N, but gaps are allowed
    remap = {int(nid): i for i, nid in enumerate(ids)}

    tets, bodies = [], []
    for line in (mesh_dir / "mesh.elements").read_text().splitlines():
        parts = line.split()
        if len(parts) == 7 and parts[2] == str(ELMER_TET4):
            bodies.append(int(parts[1]))
            tets.append([remap[int(p)] for p in parts[3:7]])
    tets = np.asarray(tets, np.int32)
    bodies = np.asarray(bodies, np.int32)

    faces, bcids = [], []
    bpath = mesh_dir / "mesh.boundary"
    if bpath.exists():
        for line in bpath.read_text().splitlines():
            parts = line.split()
            if len(parts) >= 8 and parts[4] == str(ELMER_TRI3):
                bcids.append(int(parts[1]))
                faces.append([remap[int(p)] for p in parts[5:8]])
    if faces:
        faces = np.asarray(faces, np.int32)
        bcids = np.asarray(bcids, np.int32)
        parent = _face_parents(tets, faces)
    else:
        faces, parent = extract_boundary(tets)
        bcids = np.full(faces.shape[0], 1, np.int32)

    mesh = TetMesh(nodes=coords, tets=tets, tet_body=bodies, faces=faces,
                   face_bcid=bcids, face_parent=parent)
    return mesh.with_positive_volumes()


def _face_parents(tets: np.ndarray, faces: np.ndarray) -> np.ndarray:
    """The owning tet of each boundary face (sorted-key join)."""
    all_faces = np.sort(tets[:, TET_FACES].reshape(-1, 3), axis=1)
    key = {tuple(f): i // 4 for i, f in enumerate(all_faces)}
    parent = np.empty(faces.shape[0], np.int32)
    for i, f in enumerate(np.sort(faces, axis=1)):
        parent[i] = key.get(tuple(f), -1)
    if (parent < 0).any():
        raise ValueError("boundary face without a parent tet")
    return parent


def write_elmer_mesh(mesh: TetMesh, mesh_dir) -> None:
    """Write a TetMesh as an Elmer mesh DB (ElmerGrid-compatible)."""
    mesh_dir = Path(mesh_dir)
    mesh_dir.mkdir(parents=True, exist_ok=True)

    n, m, b = mesh.n_nodes, mesh.n_tets, mesh.n_faces
    types = [(ELMER_TET4, m)]
    if b:
        types.append((ELMER_TRI3, b))
    with open(mesh_dir / "mesh.header", "w") as f:
        f.write(f"{n} {m} {b}\n{len(types)}\n")
        for t, c in types:
            f.write(f"{t} {c}\n")

    with open(mesh_dir / "mesh.nodes", "w") as f:
        for i, (x, y, z) in enumerate(mesh.nodes, start=1):
            f.write(f"{i} -1 {x:.16g} {y:.16g} {z:.16g}\n")

    with open(mesh_dir / "mesh.elements", "w") as f:
        for i in range(m):
            nd = " ".join(str(v + 1) for v in mesh.tets[i])
            f.write(f"{i+1} {mesh.tet_body[i]} {ELMER_TET4} {nd}\n")

    with open(mesh_dir / "mesh.boundary", "w") as f:
        for i in range(b):
            nd = " ".join(str(v + 1) for v in mesh.faces[i])
            f.write(f"{i+1} {mesh.face_bcid[i]} "
                    f"{mesh.face_parent[i]+1} 0 {ELMER_TRI3} {nd}\n")
