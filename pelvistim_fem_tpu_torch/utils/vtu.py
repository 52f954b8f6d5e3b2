"""Minimal VTU (VTK XML UnstructuredGrid) writer and reader (numpy twin
of pelvistim_fem_tpu/utils/vtu.py; the writer's bytes equal the JAX
package's for the same arrays).

ElmerSolver writes its results as VTU with nodal 'Potential' and
'volume current' arrays plus geometry ids; this writer emits the same
contract so VTU tools (ParaView, pyvista) read the port's solutions.  The
reader takes ascii, inline base64 and appended (raw or base64, with or
without zlib, UInt32 or UInt64 headers) VTU.
"""

from __future__ import annotations

import base64
import re
from pathlib import Path

import numpy as np

VTK_TETRA = 10
VTK_TRIANGLE = 5


def write_vtu(path, mesh, point_data=None, cell_data=None,
              include_boundary=False):
    """Write a TetMesh + nodal/cell arrays as ASCII VTU.

    point_data: {name: (N,) or (N, 3) array}; Elmer-parity names are
    'potential' and 'volume current'.  include_boundary embeds the
    boundary tri cells after the tets (VTK type 5 after 10), which flux
    integrals over VTU surface cells read.
    """
    point_data = point_data or {}
    cell_data = cell_data or {}
    n = mesh.n_nodes

    cells = [np.asarray(mesh.tets)]
    types = [np.full(mesh.n_tets, VTK_TETRA, np.uint8)]
    if include_boundary and mesh.n_faces:
        cells.append(np.asarray(mesh.faces))
        types.append(np.full(mesh.n_faces, VTK_TRIANGLE, np.uint8))
    conn = np.concatenate([c.reshape(-1) for c in cells])
    sizes = np.concatenate([np.full(len(c), c.shape[1]) for c in cells])
    offsets = np.cumsum(sizes)
    types = np.concatenate(types)
    ncells = types.size

    def arr_text(a, fmt="%.10g"):
        a = np.asarray(a)
        return "\n".join(" ".join(fmt % v for v in np.atleast_1d(row))
                         for row in a)

    parts = ['<?xml version="1.0"?>',
             '<VTKFile type="UnstructuredGrid" version="0.1" '
             'byte_order="LittleEndian">',
             '<UnstructuredGrid>',
             f'<Piece NumberOfPoints="{n}" NumberOfCells="{ncells}">']

    parts.append("<PointData>")
    for name, a in point_data.items():
        a = np.asarray(a)
        ncomp = 1 if a.ndim == 1 else a.shape[1]
        parts.append(f'<DataArray type="Float64" Name="{name}" '
                     f'NumberOfComponents="{ncomp}" format="ascii">')
        parts.append(arr_text(a))
        parts.append("</DataArray>")
    parts.append("</PointData>")

    parts.append("<CellData>")
    for name, a in cell_data.items():
        a = np.asarray(a)
        if a.shape[0] != ncells:
            pad = np.zeros(ncells - a.shape[0], a.dtype)
            a = np.concatenate([a, pad])
        ncomp = 1 if a.ndim == 1 else a.shape[1]
        dt = "Int32" if np.issubdtype(a.dtype, np.integer) else "Float64"
        parts.append(f'<DataArray type="{dt}" Name="{name}" '
                     f'NumberOfComponents="{ncomp}" format="ascii">')
        parts.append(arr_text(a, "%d" if dt == "Int32" else "%.10g"))
        parts.append("</DataArray>")
    parts.append("</CellData>")

    parts.append("<Points>")
    parts.append('<DataArray type="Float64" NumberOfComponents="3" '
                 'format="ascii">')
    parts.append(arr_text(mesh.nodes))
    parts.append("</DataArray></Points>")

    parts.append("<Cells>")
    parts.append('<DataArray type="Int64" Name="connectivity" '
                 'format="ascii">')
    parts.append(" ".join(map(str, conn)))
    parts.append("</DataArray>")
    parts.append('<DataArray type="Int64" Name="offsets" format="ascii">')
    parts.append(" ".join(map(str, offsets)))
    parts.append("</DataArray>")
    parts.append('<DataArray type="UInt8" Name="types" format="ascii">')
    parts.append(" ".join(map(str, types)))
    parts.append("</DataArray>")
    parts.append("</Cells></Piece></UnstructuredGrid></VTKFile>")

    Path(path).write_text("\n".join(parts))


def write_solution_vtu(path, mesh, case, phi, sigma_table=None):
    """Solution VTU with the ElmerSolver array contract: nodal
    'potential' and 'volume current' (+ per-cell body/GeometryIds).
    phi is a (N,) tensor on the case's device."""
    from pelvistim_fem_tpu_torch.ops import fields
    Jn = fields.nodal_average(case, fields.cell_J(case, phi, sigma_table))
    write_vtu(path, mesh,
              point_data={"potential": phi.cpu().numpy().astype(np.float64),
                          "volume current":
                              Jn.cpu().numpy().astype(np.float64)},
              cell_data={"GeometryIds": np.concatenate(
                  [np.asarray(mesh.tet_body),
                   np.asarray(mesh.face_bcid) + 100]).astype(np.int32)},
              include_boundary=True)


_DA_RE = re.compile(
    r"<DataArray(?P<attrs>[^>]*?)(?:/>|>(?P<body>.*?)</DataArray>)", re.S)

_VTK_DTYPES = {"Float64": "<f8", "Float32": "<f4", "Int64": "<i8",
               "Int32": "<i4", "UInt64": "<u8", "UInt32": "<u4",
               "Int16": "<i2", "UInt16": "<u2", "Int8": "i1",
               "UInt8": "u1"}


def _attr(attrs, key, default=None):
    m = re.search(rf'{key}="([^"]*)"', attrs)
    return m.group(1) if m else default


def _inflate(buf, hdt, compressed):
    """Decode one VTK data block starting at buf[0].

    Uncompressed layout: [nbytes:hdt][raw bytes].
    vtkZLibDataCompressor layout: [nblocks][blocksize][lastsize]
    [csize_1..n] (each hdt) followed by the zlib streams."""
    hsize = np.dtype(hdt).itemsize
    if not compressed:
        nbytes = int(np.frombuffer(buf[:hsize], hdt)[0])
        return buf[hsize:hsize + nbytes]
    import zlib
    nblocks = int(np.frombuffer(buf[:hsize], hdt)[0])
    header = np.frombuffer(buf[:hsize * (3 + nblocks)], hdt)
    csizes = header[3:3 + nblocks].astype(int)
    p = hsize * (3 + nblocks)
    out = []
    for cs in csizes:
        out.append(zlib.decompress(buf[p:p + cs]))
        p += cs
    return b"".join(out)


def _appended_block(appended, offset, encoding, hdt, compressed):
    """Extract one raw data block from the <AppendedData> stream."""
    if encoding == "raw":
        return _inflate(appended[offset:], hdt, compressed)
    # base64: the header and the payload are SEPARATE base64 streams
    # (the VTK writer convention), except that compressed blocks encode
    # the whole [header|payload] differently: header array first.
    hsize = np.dtype(hdt).itemsize
    if not compressed:
        hlen = ((hsize + 2) // 3) * 4
        nbytes = int(np.frombuffer(
            base64.b64decode(appended[offset:offset + hlen]), hdt)[0])
        dlen = ((nbytes + 2) // 3) * 4
        return base64.b64decode(
            appended[offset + hlen:offset + hlen + dlen])
    # compressed base64: first header triple to learn nblocks, then the
    # full header, then the payload stream
    hlen1 = ((hsize + 2) // 3) * 4
    # prefix decode may yield a few extra bytes (b64 groups of 3) —
    # slice to exactly one header entry before viewing
    nblocks = int(np.frombuffer(base64.b64decode(
        appended[offset:offset + hlen1])[:hsize], hdt)[0])
    hbytes = hsize * (3 + nblocks)
    hlen = ((hbytes + 2) // 3) * 4
    header = np.frombuffer(base64.b64decode(
        appended[offset:offset + hlen]), hdt, count=3 + nblocks)
    csizes = header[3:3 + nblocks].astype(int)
    dlen = ((int(csizes.sum()) + 2) // 3) * 4
    payload = base64.b64decode(
        appended[offset + hlen:offset + hlen + dlen])
    import zlib
    out, p = [], 0
    for cs in csizes:
        out.append(zlib.decompress(payload[p:p + cs]))
        p += cs
    return b"".join(out)


def read_vtu(path):
    """Parse a VTU into (points, {point_data}, connectivity, offsets,
    types, {cell_data}).

    Encodings: ascii, inline base64 ("binary"), and the APPENDED format
    (encoding="raw" or "base64") with or without vtkZLibDataCompressor and
    UInt32/UInt64 headers: the set ElmerSolver's vtu output emits.
    """
    data = Path(path).read_bytes()

    # Split off <AppendedData> first: encoding="raw" bodies are byte
    # soup that must not go through the text decoder offsets.
    appended, app_enc = None, None
    am = re.search(rb'<AppendedData[^>]*>', data)
    if am:
        app_enc = _attr(am.group(0).decode("utf8", "replace"), "encoding",
                        "base64")
        start = data.index(b"_", am.end()) + 1
        end = data.rindex(b"</AppendedData>")
        appended = data[start:end]
        text = (data[:am.end()].decode("utf8", "replace")
                + data[end:].decode("utf8", "replace"))
    else:
        text = data.decode("utf8", "replace")

    # attributes live on the <VTKFile ...> tag specifically — a leading
    # '<?xml ...?>' declaration must not satisfy the search
    vm = re.search(r"<VTKFile[^>]*>", text)
    vtag = vm.group(0) if vm else ""
    header_type = _attr(vtag, "header_type", "UInt32")
    hdt = _VTK_DTYPES[header_type]
    compressed = "compressor" in vtag

    pm = re.search(r'NumberOfPoints="(\d+)"', text)
    npts = int(pm.group(1))

    pdata_m = re.search(r"<PointData.*?>(.*?)</PointData>", text, re.S)
    cdata_m = re.search(r"<CellData.*?>(.*?)</CellData>", text, re.S)
    pts_m = re.search(r"<Points>(.*?)</Points>", text, re.S)
    cells_m = re.search(r"<Cells>(.*?)</Cells>", text, re.S)

    def parse_block(block_text):
        out = {}
        for m in _DA_RE.finditer(block_text or ""):
            attrs = m.group("attrs")
            name = _attr(attrs, "Name", "Points")
            ncomp = int(_attr(attrs, "NumberOfComponents", "1"))
            fmt = _attr(attrs, "format", "ascii")
            dt = _VTK_DTYPES[_attr(attrs, "type", "Float64")]
            body = (m.group("body") or "").strip()
            if fmt == "ascii":
                a = (np.asarray(body.split(), dtype=np.float64) if body
                     else np.empty(0))
            elif fmt == "binary":
                raw = base64.b64decode(body)
                a = np.frombuffer(_inflate(raw, hdt, compressed),
                                  dtype=dt).astype(np.float64)
            elif fmt == "appended":
                off = int(_attr(attrs, "offset", "0"))
                raw = _appended_block(appended, off, app_enc, hdt,
                                      compressed)
                a = np.frombuffer(raw, dtype=dt).astype(np.float64)
            else:
                continue
            if ncomp > 1:
                a = a.reshape(-1, ncomp)
            out[name] = a
        return out

    points = parse_block(pts_m.group(1))
    pts = next(iter(points.values())).reshape(npts, 3) if points else None
    cells = parse_block(cells_m.group(1))
    return (pts, parse_block(pdata_m.group(1) if pdata_m else ""),
            cells.get("connectivity"), cells.get("offsets"),
            cells.get("types"),
            parse_block(cdata_m.group(1) if cdata_m else ""))


def read_vtu_mesh(path):
    """A TetMesh (+ its GeometryIds BC/body tagging when present) from a
    VTU file: the port's solution files and ElmerSolver output (bodies as
    they are, boundaries at bcid + 100, as write_solution_vtu writes
    them)."""
    from pelvistim_fem_tpu_torch.mesh.boundary import extract_boundary
    from pelvistim_fem_tpu_torch.mesh.core import BC_INSULATED, TetMesh
    from pelvistim_fem_tpu_torch.mesh.io_elmer import _face_parents

    pts, _pdata, conn, offsets, types, cdata = read_vtu(path)
    conn = conn.astype(np.int64)
    offsets = offsets.astype(np.int64)
    types = types.astype(np.int64)
    begin = np.concatenate([[0], offsets[:-1]])
    tet_sel = types == VTK_TETRA
    tri_sel = types == VTK_TRIANGLE
    tets = conn[begin[tet_sel][:, None]
                + np.arange(4)[None, :]].astype(np.int32)
    geo = cdata.get("GeometryIds")
    tet_body = (geo[tet_sel].astype(np.int32) if geo is not None
                else np.ones(tets.shape[0], np.int32))
    if tri_sel.any():
        faces = conn[begin[tri_sel][:, None]
                     + np.arange(3)[None, :]].astype(np.int32)
        face_bcid = (np.maximum(geo[tri_sel] - 100, 1).astype(np.int32)
                     if geo is not None
                     else np.full(faces.shape[0], BC_INSULATED, np.int32))
        parent = _face_parents(tets, faces)
    else:
        faces, parent = extract_boundary(tets)
        face_bcid = np.full(faces.shape[0], BC_INSULATED, np.int32)
    return TetMesh(nodes=np.asarray(pts, np.float64), tets=tets,
                   tet_body=tet_body, faces=faces, face_bcid=face_bcid,
                   face_parent=parent.astype(np.int32))
