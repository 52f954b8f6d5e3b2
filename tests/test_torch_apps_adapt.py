"""The port's mesh-adaptation and imported-mesh apps on the CPU against
the JAX package: run_step03 --smoke --adapt 1 and --adapt-local 1 cycle by
cycle against the reference's own calls (dev/torch_port_anchors.py's
adapt and adapt_local, the loops of its run_adapt / run_adapt_local),
run_step03 --save-vtu --export-elmer, meshtool and crossval_elmer in a
temporary directory."""

import argparse
import contextlib
import hashlib
import importlib.util
import io
from pathlib import Path

import numpy as np
import pytest

from pelvistim_fem_tpu_torch.apps import crossval_elmer, meshtool, run_step03
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def anchors():
    spec = importlib.util.spec_from_file_location(
        "torch_port_anchors", ROOT / "dev" / "torch_port_anchors.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(app, argv):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = app.run(app.parse_args(argv))
    return out, buf.getvalue()


def _allocation(knots, keep):
    """Cells per kept segment of a knot vector."""
    k = np.asarray(knots)
    edges = np.unique(np.concatenate([[k[0], k[-1]], keep]))
    return np.histogram(0.5 * (k[1:] + k[:-1]), bins=edges)[0].tolist()


def test_adapt_smoke_matches_reference(anchors):
    want = anchors.adapt(coarse=True, cycles=1)
    out, text = _run(run_step03, ["--smoke", "--adapt", "1", "--device",
                                  "cpu"])
    assert out["exit"] == 0 and "PASS" in text
    assert len(out["cycles"]) == len(want["cycles"]) == 2
    keeps = ((), (), want["keep_z"])
    for got, ref in zip(out["cycles"], want["cycles"]):
        assert got["tets"] == ref["tets"]
        assert got["residual"] <= 1e-8
        np.testing.assert_allclose(got["rel"], ref["rel"], rtol=1e-5)
        np.testing.assert_allclose(got["eta"], ref["eta"], rtol=1e-5)
        assert abs(got["flux_err"] - ref["flux_err"]) <= 1e-5
        for k, rk, keep in zip(got["knots"], ref["knots"], keeps):
            assert _allocation(k, keep) == _allocation(rk, keep)
            np.testing.assert_allclose(k, rk, rtol=0,
                                       atol=1e-9 * (rk[-1] - rk[0]))


def test_adapt_local_smoke_matches_reference(anchors):
    want = anchors.adapt_local(coarse=True, cycles=1)
    out, text = _run(run_step03, ["--smoke", "--adapt-local", "1",
                                  "--device", "cpu"])
    assert out["exit"] == 0
    assert "amg: 3 levels" in text
    for c in out["cycles"]:
        assert len(c["amg_sizes"]) == 3 and c["amg_build_s"] > 0
        assert c["amg_sizes"][0] == int(c["case"].free_mask.sum())
    cyc, ref = out["cycles"], want["cycles"]
    assert len(cyc) == len(ref) == 2
    assert abs(cyc[0]["iterations"] - ref[0]["iterations"]) <= 2
    for got, r in zip(cyc, ref):
        assert got["residual"] <= 1e-8
        for k in ("rel", "eta", "peak_J_skin_no_elec"):
            np.testing.assert_allclose(got[k], r[k], rtol=1e-5, err_msg=k)
        assert abs(got["flux_err"] - r["flux_err"]) <= 1e-5
        assert got["phases"]["amg build"] > 0
    marks = cyc[0]["marked"]
    assert int(marks.sum()) == ref[0]["marked"]
    assert hashlib.sha1(np.packbits(marks)).hexdigest() == \
        ref[0]["marks_sha1"]
    assert cyc[1]["tets"] == ref[1]["tets"] > cyc[0]["tets"]


def test_step03_save_vtu_and_export_elmer(tmp_path):
    """Both loops write the solution VTU and the Elmer case; the Elmer
    case equals the JAX package's export of the same case byte for byte,
    and the VTU's potential is the run's."""
    from pelvistim_fem_tpu.models.ankle import build_layered_case as jb
    from pelvistim_fem_tpu.utils.sif import export_elmer_case as jexport
    from pelvistim_fem_tpu_torch.utils.vtu import read_vtu
    for mode in ([], ["--batch"]):
        d = tmp_path / ("batch" if mode else "serial")
        out, _ = _run(run_step03, ["--smoke", "--save-vtu",
                                   "--export-elmer", "--device", "cpu",
                                   "--outdir", str(d), *mode])
        (case_dir,) = [p for p in d.iterdir() if p.is_dir()]
        assert (case_dir / "results" / "case_t0001.vtu").is_file()
        pts, pdata, *_ = read_vtu(case_dir / "results" / "case_t0001.vtu")
        assert np.isfinite(pdata["potential"]).all()
        assert pdata["volume current"].shape == (len(pts), 3)
        if not mode:
            jcase, _, jmesh = jb(coarse=True, with_mesh=True)
            jexport(jcase, jmesh, tmp_path / "ref")
            for f in ("case.sif", "elmer_mesh/mesh.nodes",
                      "elmer_mesh/mesh.elements",
                      "elmer_mesh/mesh.boundary", "elmer_mesh/mesh.header"):
                assert (case_dir / f).read_bytes() == \
                    (tmp_path / "ref" / f).read_bytes(), f
        else:
            assert (case_dir / "case.sif").is_file()
        assert len(out["rows"]) == 1


def test_meshtool_and_crossval(tmp_path):
    from pelvistim_fem_tpu.apps import meshtool as jmeshtool
    run_step03.run(run_step03.parse_args(
        ["--smoke", "--export-elmer", "--device", "cpu", "--outdir",
         str(tmp_path / "s03")]))
    (case_dir,) = [p for p in (tmp_path / "s03").iterdir() if p.is_dir()]
    db = case_dir / "elmer_mesh"
    # inspect prints what the reference's prints
    _, text = _run(meshtool, ["inspect", str(db)])
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        jmeshtool.cmd_inspect(argparse.Namespace(input=str(db)))
    assert text == buf.getvalue()
    assert "quality" in text and "WARNING" not in text
    # convert: Elmer DB -> msh -> vtu, and boundaries
    _run(meshtool, ["convert", str(db), str(tmp_path / "m.msh")])
    _run(meshtool, ["convert", str(tmp_path / "m.msh"),
                    str(tmp_path / "m.vtu")])
    out, _ = _run(meshtool, ["boundaries", str(tmp_path / "m.vtu"),
                             str(tmp_path / "b.msh")])
    assert out["faces"] > 0 and (tmp_path / "b.msh").is_file()
    info, _ = _run(meshtool, ["inspect", str(tmp_path / "m.vtu")])
    ref, _ = _run(meshtool, ["inspect", str(db)])
    assert info["tets"] == ref["tets"] and info["nodes"] == ref["nodes"]
    # solve with the estimate and the solution VTU
    out, text = _run(meshtool, ["solve", str(tmp_path / "m.msh"), "--out",
                                str(tmp_path / "solve"), "--vtu",
                                "--estimate", "--device", "cpu"])
    assert out["converged"] and out["residual"] <= 1e-8
    assert 0 < out["row"]["zz_error_rel"] < 1
    assert (tmp_path / "solve" / "summary.json").is_file()
    assert (tmp_path / "solve" / "solution.vtu").is_file()
    # crossval: without a result VTU it writes ours, then holds it
    first, _ = _run(crossval_elmer, [str(case_dir), "--device", "cpu"])
    assert first["wrote"] and first["exit"] == 0
    second, text = _run(crossval_elmer, [str(case_dir), "--device", "cpu"])
    assert "CROSSVAL PASS" in text and second["exit"] == 0
    # the written VTU keeps 10 significant digits
    assert second["potential_rel_l2"] <= 5e-10
    assert second["Jmag_rel_l2"] <= 5e-10
    np.testing.assert_allclose(second["row"]["compliance_V"],
                               out["row"]["compliance_V"], rtol=1e-5)


def test_new_entry_points_raise_without_a_card(tmp_path):
    """With no CUDA device, every new entry point raises unless it is
    given device="cpu"; nothing falls back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from pelvistim_fem_tpu_torch.models import imported
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_spec
    from pelvistim_fem_tpu_torch.ops.stencil_estimate import \
        lattice_zz_error
    spec, _ = build_pressure_spec(coarse=True)
    calls = [
        lambda: run_step03.main(["--smoke", "--adapt", "1"]),
        lambda: run_step03.main(["--smoke", "--adapt-local", "1"]),
        lambda: lattice_zz_error(spec, np.zeros(len(spec.grid_index))),
        lambda: imported.solve_imported(tmp_path / "m.msh"),
        lambda: meshtool.main(["solve", str(tmp_path / "m.msh")]),
        lambda: crossval_elmer.main([str(tmp_path)]),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
