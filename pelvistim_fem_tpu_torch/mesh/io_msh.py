"""Gmsh `.msh` interchange, ASCII v2.2 and v4.1 in, v2.2 out (numpy twin
of pelvistim_fem_tpu/mesh/io_msh.py; the writer's bytes equal the JAX
package's).

Element types: 4 = tet4 (volume, physical tag -> body id), 2 = tri3
(surface, physical tag -> bcid).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from pelvistim_fem_tpu_torch.mesh.boundary import extract_boundary
from pelvistim_fem_tpu_torch.mesh.core import TetMesh
from pelvistim_fem_tpu_torch.mesh.io_elmer import _face_parents

GMSH_TRI3 = 2
GMSH_TET4 = 4


def read_msh(path) -> TetMesh:
    lines = Path(path).read_text().splitlines()
    version = None
    for i, line in enumerate(lines):
        if line.startswith("$MeshFormat"):
            version = float(lines[i + 1].split()[0])
            break
    if version is None:
        raise ValueError("not a Gmsh .msh file (no $MeshFormat)")
    if version >= 4.0:
        return _read_msh4(lines)
    return _read_msh2(lines)


def _section(lines, name):
    start = lines.index(f"${name}") + 1
    end = lines.index(f"$End{name}")
    return lines[start:end]


def _finalize(coords, tets, bodies, faces, bcids) -> TetMesh:
    tets = np.asarray(tets, np.int32)
    bodies = np.asarray(bodies, np.int32)
    if bodies.size and bodies.min() < 1:
        bodies = bodies - bodies.min() + 1
    if len(faces):
        faces = np.asarray(faces, np.int32)
        bcids = np.asarray(bcids, np.int32)
        parent = _face_parents(tets, faces)
    else:
        faces, parent = extract_boundary(tets)
        bcids = np.full(faces.shape[0], 1, np.int32)
    mesh = TetMesh(nodes=np.asarray(coords), tets=tets, tet_body=bodies,
                   faces=faces, face_bcid=bcids, face_parent=parent)
    return mesh.with_positive_volumes()


def _read_msh2(lines) -> TetMesh:
    sec = _section(lines, "Nodes")
    n = int(sec[0])
    remap = {}
    coords = np.empty((n, 3))
    for i, line in enumerate(sec[1:1 + n]):
        p = line.split()
        remap[int(p[0])] = i
        coords[i] = [float(p[1]), float(p[2]), float(p[3])]

    sec = _section(lines, "Elements")
    m = int(sec[0])
    tets, bodies, faces, bcids = [], [], [], []
    for line in sec[1:1 + m]:
        p = line.split()
        etype = int(p[1])
        ntags = int(p[2])
        phys = int(p[3]) if ntags >= 1 else 0
        nodes = [remap[int(v)] for v in p[3 + ntags:]]
        if etype == GMSH_TET4:
            tets.append(nodes)
            bodies.append(phys)
        elif etype == GMSH_TRI3:
            faces.append(nodes)
            bcids.append(phys)
    return _finalize(coords, tets, bodies, faces, bcids)


def _read_msh4(lines) -> TetMesh:
    # $Entities maps (dim, entity tag) -> physical tag
    ent_phys = {}
    if "$Entities" in lines:
        sec = _section(lines, "Entities")
        counts = list(map(int, sec[0].split()))  # points curves surfs vols
        idx = 1 + counts[0]                      # skip the points
        for dim, cnt in [(1, counts[1]), (2, counts[2]), (3, counts[3])]:
            for _ in range(cnt):
                p = sec[idx].split()
                idx += 1
                tag = int(p[0])
                nphys = int(p[7])
                if nphys >= 1:
                    ent_phys[(dim, tag)] = int(p[8])

    sec = _section(lines, "Nodes")
    hdr = sec[0].split()
    nblocks, n_total = int(hdr[0]), int(hdr[1])
    remap = {}
    coords = np.empty((n_total, 3))
    idx, out = 1, 0
    for _ in range(nblocks):
        _, _, _, nnodes = map(int, sec[idx].split())
        idx += 1
        tags = [int(sec[idx + k]) for k in range(nnodes)]
        idx += nnodes
        for k in range(nnodes):
            p = sec[idx + k].split()
            remap[tags[k]] = out
            coords[out] = [float(p[0]), float(p[1]), float(p[2])]
            out += 1
        idx += nnodes

    sec = _section(lines, "Elements")
    nblocks = int(sec[0].split()[0])
    idx = 1
    tets, bodies, faces, bcids = [], [], [], []
    for _ in range(nblocks):
        dim, etag, etype, nelem = map(int, sec[idx].split())
        idx += 1
        phys = ent_phys.get((dim, etag), etag)
        for k in range(nelem):
            p = sec[idx + k].split()
            nodes = [remap[int(v)] for v in p[1:]]
            if etype == GMSH_TET4:
                tets.append(nodes)
                bodies.append(phys)
            elif etype == GMSH_TRI3:
                faces.append(nodes)
                bcids.append(phys)
        idx += nelem
    return _finalize(coords, tets, bodies, faces, bcids)


def write_msh2(mesh: TetMesh, path) -> None:
    """Write ASCII Gmsh v2.2 (tri3 boundary first, then tet4 volume)."""
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.n_nodes}\n")
        for i, (x, y, z) in enumerate(mesh.nodes, start=1):
            f.write(f"{i} {x:.16g} {y:.16g} {z:.16g}\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{mesh.n_faces + mesh.n_tets}\n")
        eid = 1
        for i in range(mesh.n_faces):
            nd = " ".join(str(v + 1) for v in mesh.faces[i])
            f.write(f"{eid} {GMSH_TRI3} 2 {mesh.face_bcid[i]} "
                    f"{mesh.face_bcid[i]} {nd}\n")
            eid += 1
        for i in range(mesh.n_tets):
            nd = " ".join(str(v + 1) for v in mesh.tets[i])
            f.write(f"{eid} {GMSH_TET4} 2 {mesh.tet_body[i]} "
                    f"{mesh.tet_body[i]} {nd}\n")
            eid += 1
        f.write("$EndElements\n")
