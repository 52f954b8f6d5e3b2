"""The port's mesh and case interchange against the JAX package's on the
CPU: Gmsh .msh, the Elmer mesh DB, VTU and the Elmer .sif.  What the
writers produce is byte-identical to the reference's for the same mesh
and fields; what the readers return equals the reference readers' (and
round-trips the written mesh); tet_quality is equal."""

import base64
import dataclasses
import zlib

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pelvistim_fem_tpu.mesh import core as jcore
from pelvistim_fem_tpu.mesh import io_elmer as jelmer
from pelvistim_fem_tpu.mesh import io_msh as jmsh
from pelvistim_fem_tpu.models.ankle import build_layered_case as jbuild
from pelvistim_fem_tpu.utils import sif as jsif
from pelvistim_fem_tpu.utils import vtu as jvtu
from pelvistim_fem_tpu_torch.mesh import core, io_elmer, io_msh
from pelvistim_fem_tpu_torch.models.ankle import build_layered_case
from pelvistim_fem_tpu_torch.utils import sif, vtu
from torch_threads import one_torch_thread  # noqa: E402,F401

MESH_FIELDS = ("nodes", "tets", "tet_body", "faces", "face_bcid",
               "face_parent")


@pytest.fixture(scope="module")
def built():
    """The coarse step03 case (current mode) in both packages, its mesh
    with scrambled bcids and no lattice, and a smooth nodal field."""
    case, params, mesh = build_layered_case(coarse=True, with_mesh=True,
                                            device="cpu")
    jcase, _, _ = jbuild(coarse=True, with_mesh=True)
    bc = mesh.face_bcid.copy()
    bc[bc == 1], bc[bc == 2] = 7, 9
    m = dataclasses.replace(mesh, face_bcid=bc, lattice=None)
    x = mesh.nodes
    phi = np.sin(50 * x[:, 0]) * x[:, 2] + 3 * x[:, 1]
    return dict(case=case, jcase=jcase, mesh=m, params=params, phi=phi)


def _assert_mesh_equal(got, want):
    for f in MESH_FIELDS:
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _bytes(path):
    if path.is_dir():
        return {p.name: p.read_bytes() for p in sorted(path.iterdir())}
    return path.read_bytes()


def test_msh2_and_elmer_writers_byte_identical_and_read_back(built,
                                                             tmp_path):
    m = built["mesh"]
    io_msh.write_msh2(m, tmp_path / "a.msh")
    jmsh.write_msh2(m, tmp_path / "b.msh")
    assert _bytes(tmp_path / "a.msh") == _bytes(tmp_path / "b.msh")
    io_elmer.write_elmer_mesh(m, tmp_path / "a_db")
    jelmer.write_elmer_mesh(m, tmp_path / "b_db")
    a = _bytes(tmp_path / "a_db")
    assert sorted(a) == ["mesh.boundary", "mesh.elements", "mesh.header",
                         "mesh.nodes"]
    assert a == _bytes(tmp_path / "b_db")
    for got, want in ((io_msh.read_msh(tmp_path / "a.msh"),
                       jmsh.read_msh(tmp_path / "a.msh")),
                      (io_elmer.read_elmer_mesh(tmp_path / "a_db"),
                       jelmer.read_elmer_mesh(tmp_path / "a_db"))):
        _assert_mesh_equal(got, want)
        # the written mesh comes back (it has positive volumes already;
        # 16 printed digits round the coordinates)
        np.testing.assert_allclose(got.nodes, m.nodes, rtol=1e-15)
        for f in MESH_FIELDS[1:]:
            np.testing.assert_array_equal(getattr(got, f), getattr(m, f))


def _msh4_text(mesh):
    """A Gmsh 4.1 file of a mesh: one volume entity per body (physical
    tag = body id), one surface entity per bcid (physical tag 100 +
    bcid), node tags offset by 10."""
    bodies, bcids = np.unique(mesh.tet_body), np.unique(mesh.face_bcid)
    out = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat", "$Entities",
           f"0 0 {len(bcids)} {len(bodies)}"]
    for b in bcids:
        out.append(f"{b} 0 0 0 1 1 1 1 {100 + b} 0")
    for b in bodies:
        out.append(f"{b} 0 0 0 1 1 1 1 {b} 0")
    out += ["$EndEntities", "$Nodes",
            f"1 {mesh.n_nodes} 11 {10 + mesh.n_nodes}",
            f"3 1 0 {mesh.n_nodes}"]
    out += [str(11 + i) for i in range(mesh.n_nodes)]
    out += [f"{x:.16g} {y:.16g} {z:.16g}" for x, y, z in mesh.nodes]
    out += ["$EndNodes", "$Elements",
            f"{len(bcids) + len(bodies)} {mesh.n_faces + mesh.n_tets} 1 "
            f"{mesh.n_faces + mesh.n_tets}"]
    eid = 1
    for dim, ids, conn, et in ((2, mesh.face_bcid, mesh.faces, 2),
                               (3, mesh.tet_body, mesh.tets, 4)):
        for b in np.unique(ids):
            sel = np.flatnonzero(ids == b)
            out.append(f"{dim} {b} {et} {len(sel)}")
            for i in sel:
                out.append(f"{eid} " + " ".join(str(v + 11)
                                                for v in conn[i]))
                eid += 1
    out.append("$EndElements")
    return "\n".join(out) + "\n"


def test_msh4_reader_matches_reference(built, tmp_path):
    m = built["mesh"]
    p = tmp_path / "m4.msh"
    p.write_text(_msh4_text(m))
    got, want = io_msh.read_msh(p), jmsh.read_msh(p)
    _assert_mesh_equal(got, want)
    np.testing.assert_allclose(got.nodes, m.nodes, rtol=1e-15)
    assert set(np.unique(got.face_bcid)) == {103, 107, 109}
    with pytest.raises(ValueError, match="MeshFormat"):
        (tmp_path / "bad.msh").write_text("$Nodes\n0\n$EndNodes\n")
        io_msh.read_msh(tmp_path / "bad.msh")


def test_vtu_writers_byte_identical_and_read_back(built, tmp_path):
    m, phi = built["mesh"], built["phi"]
    J = np.stack([phi, 2 * phi, -phi], 1)
    geo = np.concatenate([m.tet_body, m.face_bcid + 100]).astype(np.int32)
    kw = dict(point_data={"potential": phi, "volume current": J},
              cell_data={"GeometryIds": geo, "pad": np.arange(5.0)},
              include_boundary=True)
    vtu.write_vtu(tmp_path / "a.vtu", m, **kw)
    jvtu.write_vtu(tmp_path / "b.vtu", m, **kw)
    assert _bytes(tmp_path / "a.vtu") == _bytes(tmp_path / "b.vtu")
    got, want = vtu.read_vtu(tmp_path / "a.vtu"), \
        jvtu.read_vtu(tmp_path / "a.vtu")
    for g, w in zip(got, want):
        if isinstance(g, dict):
            assert sorted(g) == sorted(w)
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        else:
            np.testing.assert_array_equal(g, w)
    back = vtu.read_vtu_mesh(tmp_path / "a.vtu")
    _assert_mesh_equal(back, jvtu.read_vtu_mesh(tmp_path / "a.vtu"))
    np.testing.assert_allclose(back.nodes, m.nodes, rtol=1e-9)
    for f in MESH_FIELDS[1:]:
        np.testing.assert_array_equal(getattr(back, f), getattr(m, f))


def test_solution_vtu_matches_reference(built, tmp_path):
    """write_solution_vtu: the same file but for the 'volume current'
    sums, which the two packages order differently (each value equal to
    its 10 printed digits or one unit of the last)."""
    case, jcase, phi = built["case"], built["jcase"], built["phi"]
    mesh = dataclasses.replace(built["mesh"], face_bcid=np.asarray(
        case.face_bcid.numpy(), np.int32))
    vtu.write_solution_vtu(tmp_path / "a.vtu", mesh, case,
                           torch.as_tensor(phi))
    jvtu.write_solution_vtu(tmp_path / "b.vtu", mesh, jcase,
                            jnp.asarray(phi))
    ga, gb = vtu.read_vtu(tmp_path / "a.vtu"), vtu.read_vtu(tmp_path /
                                                            "b.vtu")
    np.testing.assert_array_equal(ga[1]["potential"], gb[1]["potential"])
    np.testing.assert_allclose(ga[1]["volume current"],
                               gb[1]["volume current"], rtol=2e-9,
                               atol=1e-12)
    for i in (0, 2, 3, 4):
        np.testing.assert_array_equal(ga[i], gb[i])
    np.testing.assert_array_equal(ga[5]["GeometryIds"],
                                  gb[5]["GeometryIds"])


def _synth_appended(path, *, encoding, compress, header_type):
    """A VTU in the appended format (ElmerSolver's output) of a 2-tet mesh
    with a potential and GeometryIds."""
    hdt = np.dtype("<u8" if header_type == "UInt64" else "<u4")
    arrays = [
        ("PointData", "potential", "Float64", 1, np.linspace(0, 1, 5)),
        ("CellData", "GeometryIds", "Int32", 1, np.array([1, 2], np.int32)),
        ("Points", "Points", "Float64", 3,
         np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0], [0, 0, 1], [1, 1, 1.0]])),
        ("Cells", "connectivity", "Int64", 1,
         np.array([0, 1, 2, 3, 1, 2, 3, 4], np.int64)),
        ("Cells", "offsets", "Int64", 1, np.array([4, 8], np.int64)),
        ("Cells", "types", "UInt8", 1, np.array([10, 10], np.uint8)),
    ]
    blocks = []
    comp = (' compressor="vtkZLibDataCompressor"' if compress else "")
    xml = [f'<VTKFile type="UnstructuredGrid" version="1.0" '
           f'byte_order="LittleEndian" header_type="{header_type}"{comp}>',
           "<UnstructuredGrid>", '<Piece NumberOfPoints="5" '
           'NumberOfCells="2">']
    cur = None
    for sec, name, typ, ncomp, a in arrays:
        raw = np.ascontiguousarray(a).tobytes()
        off = sum(len(b) for b in blocks)
        if compress:
            cd = zlib.compress(raw)
            payload = (np.array([1, len(raw), len(raw), len(cd)],
                                hdt).tobytes(), cd)
        else:
            payload = (np.array([len(raw)], hdt).tobytes(), raw)
        blocks.append(b"".join(payload) if encoding == "raw" else
                      b"".join(base64.b64encode(p) for p in payload))
        if sec != cur:
            if cur is not None:
                xml.append(f"</{cur}>")
            xml.append(f"<{sec}>")
            cur = sec
        xml.append(f'<DataArray type="{typ}" Name="{name}" '
                   f'NumberOfComponents="{ncomp}" format="appended" '
                   f'offset="{off}"/>')
    xml += [f"</{cur}>", "</Piece></UnstructuredGrid>"]
    head = "\n".join(xml).encode() + \
        f'\n<AppendedData encoding="{encoding}">\n_'.encode()
    path.write_bytes(head + b"".join(blocks)
                     + b"\n</AppendedData>\n</VTKFile>\n")


@pytest.mark.parametrize("encoding,compress,header_type", [
    ("raw", False, "UInt32"), ("raw", True, "UInt64"),
    ("base64", False, "UInt32"), ("base64", True, "UInt64"),
])
def test_read_vtu_appended_matches_reference(tmp_path, encoding, compress,
                                             header_type):
    p = tmp_path / "a.vtu"
    _synth_appended(p, encoding=encoding, compress=compress,
                    header_type=header_type)
    p2 = tmp_path / "decl.vtu"
    p2.write_bytes(b'<?xml version="1.0"?>\n' + p.read_bytes())
    for path in (p, p2):
        got, want = vtu.read_vtu(path), jvtu.read_vtu(path)
        for g, w in zip(got, want):
            if isinstance(g, dict):
                assert sorted(g) == sorted(w)
                for k in g:
                    np.testing.assert_array_equal(g[k], w[k])
            else:
                np.testing.assert_array_equal(g, w)
        np.testing.assert_array_equal(got[2], [0, 1, 2, 3, 1, 2, 3, 4])
        _assert_mesh_equal(vtu.read_vtu_mesh(path), jvtu.read_vtu_mesh(path))


@pytest.mark.parametrize("mode", ["current", "voltage"])
def test_sif_and_elmer_case_byte_identical(built, tmp_path, mode):
    from pelvistim_fem_tpu.models.case import build_case as jb
    from pelvistim_fem_tpu_torch.models.case import build_case as tb
    mesh = dataclasses.replace(built["mesh"], face_bcid=np.asarray(
        built["case"].face_bcid.numpy(), np.int32))
    sig = dict(zip(range(1, 6), (0.35, 0.04, 1e-3, 5e-3, 5e-3)))
    kw = dict(mode=mode, injected_current_A=5e-3)
    case, jcase = tb(mesh, sig, device="cpu", **kw), jb(mesh, sig, **kw)
    text = sif.write_sif(tmp_path / "a.sif", case, tol=1e-8)
    assert text == jsif.write_sif(tmp_path / "b.sif", jcase, tol=1e-8)
    assert _bytes(tmp_path / "a.sif") == _bytes(tmp_path / "b.sif")
    sif.export_elmer_case(case, mesh, tmp_path / "a")
    jsif.export_elmer_case(jcase, mesh, tmp_path / "b")
    assert _bytes(tmp_path / "a" / "case.sif") == \
        _bytes(tmp_path / "b" / "case.sif")
    assert _bytes(tmp_path / "a" / "elmer_mesh") == \
        _bytes(tmp_path / "b" / "elmer_mesh")
    assert (tmp_path / "a" / "results").is_dir()


def test_tet_quality_matches_reference(built):
    m = built["mesh"]
    nodes = np.concatenate([m.nodes, [[0.0, 0.0, 0.0], [1e-3, 0, 0],
                                      [2e-3, 0, 0], [0, 1e-3, 0]]])
    n = m.n_nodes
    # a sliver and an exactly degenerate (collinear) tet
    tets = np.concatenate([m.tets, [[n, n + 1, n + 3, n + 2],
                                    [n, n + 1, n + 2, n + 3]]])
    nodes[n + 2] = [2e-3, 1e-9, 0.0]
    got = core.tet_quality(nodes, tets)
    want = jcore.tet_quality(nodes, tets)
    for k in ("radius_ratio", "min_dihedral"):
        np.testing.assert_array_equal(got[k], want[k])
    assert got["radius_ratio"][:m.n_tets].min() > 0.1
