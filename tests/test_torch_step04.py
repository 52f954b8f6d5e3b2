"""PyTorch port: the step04 app (apps/run_step04 with --thermal and
--nonlinear) against the JAX package's app, and the pieces it adds to
the port (fields.cell_power_density, fields.cell_centers,
metrics.compliance_voltage, report.print_sanity_table), on the CPU.

Both apps run --smoke --thermal --nonlinear on one 3-level parameter
file (written as JSON that YAML reads the same) with the skin law at
amp 0.5 and width 2000 V/m: the app's default law (amp 4, width 500)
takes 100-230 Picard passes per level on this mesh, whose count follows
rounding, and minutes on the CPU; chip_smoke holds the default law at
full size on the card.  Rows agree as chip_smoke holds them: rtol 1e-5
plus one unit of the row's rounding (flux_err atol 1e-5), the f32
thermal columns to 2e-4 degC, the nonlinear columns to rtol 1e-5.
"""

import contextlib
import io
import json
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models.pressure import \
    build_pressure_case as jax_pressure_case  # noqa: E402
from pelvistim_fem_tpu.ops import fields as jfields  # noqa: E402
from pelvistim_fem_tpu.ops import metrics as jmetrics  # noqa: E402
from pelvistim_fem_tpu.utils import report as jreport  # noqa: E402

from pelvistim_fem_tpu_torch.models.pressure import \
    build_pressure_case  # noqa: E402
from pelvistim_fem_tpu_torch.ops import fields, metrics  # noqa: E402
from pelvistim_fem_tpu_torch.utils import report  # noqa: E402
from pelvistim_fem_tpu_torch.utils.config import \
    default_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

LEVELS = [0, 7, 14]
NL_FLAGS = ["--nl-amp", "0.5", "--nl-w", "2000"]
# rows: key -> decimals the row keeps
ROW_KEYS = {"compliance_V": 3, "contact_impedance_ohm": 1, "roi_mean_E": 4,
            "charge_density_mC_cm2": 6, "total_current_A": 8,
            "peak_J_skin_no_elec": 6}


@pytest.fixture(scope="module")
def cases():
    jcase, params = jax_pressure_case(coarse=True, dtype=jnp.float64)
    tcase, _ = build_pressure_case(coarse=True, dtype=torch.float64,
                                   device="cpu")
    rng = np.random.default_rng(11)
    phis = rng.standard_normal((3, tcase.n_nodes))
    tables = np.tile(np.asarray(jcase.sigma_table), (3, 1))
    tables[:, 1:] *= 1.0 + rng.random((3, tables.shape[1] - 1))
    return jcase, tcase, phis, tables


def test_cell_power_density_and_centers_match_reference(cases):
    """Lane-stacked sigma |E|^2 against the reference's vmapped one, and
    each lane alone; tet centroids."""
    jcase, tcase, phis, tables = cases
    got = fields.cell_power_density(tcase, torch.as_tensor(phis),
                                    torch.as_tensor(tables))
    want = jax.vmap(lambda ph, s: jfields.cell_power_density(jcase, ph, s))(
        jnp.asarray(phis), jnp.asarray(tables))
    assert got.shape == (3, tcase.n_tets)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)
    one = fields.cell_power_density(tcase, torch.as_tensor(phis[1]))
    np.testing.assert_allclose(
        one.numpy(), np.asarray(jfields.cell_power_density(
            jcase, jnp.asarray(phis[1]))), rtol=1e-12, atol=0)
    np.testing.assert_allclose(fields.cell_centers(tcase).numpy(),
                               np.asarray(jfields.cell_centers(jcase)),
                               rtol=1e-15, atol=0)


def test_compliance_voltage_matches_reference(cases):
    jcase, tcase, phis, _ = cases
    for phi in phis:
        assert metrics.compliance_voltage(tcase, torch.as_tensor(phi)) == \
            jmetrics.compliance_voltage(jcase, jnp.asarray(phi))


def _printed(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def test_sanity_table_text_equals_reference():
    """The same rows print the same table, line for line, including a row
    without a pressure label and NaN cells."""
    params = default_params("step04_pressure")
    rows = [dict(pressure_label="p01", total_current_A=0.00505261,
                 I_return_A=0.00504828, flux_err=0.000856,
                 compliance_V=606.036, roi_frac_muscle=0.8611,
                 roi_frac_fat=0.1389, roi_frac_skin=0.0),
            dict(t_fat_mm=5.0, elec_r_mm=10.0, total_current_A=float("nan"),
                 flux_err=0.0123)]
    for p in (params, dict(params, stim={"control_mode": "voltage"})):
        assert _printed(report.print_sanity_table, rows, p) == \
            _printed(jreport.print_sanity_table, rows, p)


def _params_file(tmp_path):
    """The step04 parameters cut to 3 contact levels, as JSON whose
    floats all carry a decimal point (YAML 1.1 reads '5e-05' as a
    string)."""
    p = default_params("step04_pressure")
    sw = p["pressure_sweep"]
    for key in ("sigma_contact_Spm", "labels"):
        sw[key] = [sw[key][i] for i in LEVELS]
    text = re.sub(r"(?<![\d.])(\d+)e([-+]?\d+)", r"\1.0e\2",
                  json.dumps(p, indent=1))
    path = tmp_path / "step04_3levels.json"
    path.write_text(text)
    return path


def _run_apps(tmp_path, monkeypatch):
    from pelvistim_fem_tpu.apps import run_step04 as japp
    from pelvistim_fem_tpu_torch.apps import run_step04 as app
    params = _params_file(tmp_path)
    flags = ["--smoke", "--thermal", "--nonlinear", "--params",
             str(params)] + NL_FLAGS
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = app.run(app.parse_args(flags + ["--device", "cpu", "--outdir",
                                              str(tmp_path / "port")]))
    monkeypatch.setattr(sys, "argv", ["run_step04"] + flags + [
        "--outdir", str(tmp_path / "jax")])
    jbuf = io.StringIO()
    with contextlib.redirect_stdout(jbuf):
        japp.main()
    load = lambda d: json.loads((tmp_path / d / "summary.json").read_text())
    return out, load("port"), load("jax"), buf.getvalue(), jbuf.getvalue()


def _block(text, start, end):
    i = text.index(start)
    return text[i:text.index(end, i + len(start))]


def test_app_matches_reference_app(tmp_path, monkeypatch):
    out, rows, jrows, text, jtext = _run_apps(tmp_path, monkeypatch)
    assert [r["pressure_label"] for r in rows] == \
        [r["pressure_label"] for r in jrows] and len(rows) == len(LEVELS)
    assert list(rows[0]) == list(jrows[0])          # same columns, order
    solve = out["solve"]
    assert bool(solve.converged.all()) and float(solve.residual.max()) <= 1e-8
    for r, jr in zip(rows, jrows):
        for key, nd in ROW_KEYS.items():
            assert abs(r[key] - jr[key]) <= (1e-5 * abs(jr[key])
                                             + 1.001 * 10.0 ** -nd), key
        assert abs(r["flux_err"] - jr["flux_err"]) <= 1e-5
        for key in ("dT_skin_max_C", "dT_max_C"):
            assert abs(r[key] - jr[key]) <= 2e-4, key
            assert r[key] > 0
        for key in ("compliance_V_nl", "skin_sigma_rise"):
            np.testing.assert_allclose(r[key], jr[key], rtol=1e-5,
                                       err_msg=key)
        assert r["compliance_V_nl"] < r["compliance_V"]
    assert all(bool(r.converged) and float(r.residual) <= 1e-8
               for r in out["nonlinear"])
    # the heating course of the driest level: the same t95, the steady
    # rise within 2e-4 degC
    t95 = r"t95 = (\S+) min to 95% of the steady (\S+) degC"
    (got, rise), = re.findall(t95, text)
    (want, jrise), = re.findall(t95, jtext)
    assert got == want and float(got) == out["t95"]
    assert abs(float(rise) - float(jrise)) <= 2e-4
    sanity = ("SANITY TABLE", "=" * 100 + "\n\n")
    assert _block(text, *sanity) == _block(jtext, *sanity)
    heads = ("  compliance_V :", "  impedance    :", "  roi_mean_E   :")
    trend = [ln for ln in text.splitlines() if ln.startswith(heads)]
    assert len(trend) == 3 and all(ln in jtext for ln in trend)
    assert set(out["phases"]) == {"build", "solve", "extract", "thermal",
                                  "nonlinear"}


def test_new_modules_import_without_jax_or_yaml():
    """The step04 app and the bioheat and nonlinear modules import in a
    process where jax and yaml cannot be imported, and pull in nothing
    of the JAX package."""
    import subprocess
    from pathlib import Path
    code = """
import sys
sys.modules["jax"] = None
sys.modules["yaml"] = None
import pelvistim_fem_tpu_torch.apps.run_step04
import pelvistim_fem_tpu_torch.ops.bioheat
import pelvistim_fem_tpu_torch.ops.nonlinear
args = pelvistim_fem_tpu_torch.apps.run_step04.parse_args(["--thermal"])
assert args.device == "cuda" and args.thermal and not args.nonlinear
bad = [m for m in sys.modules
       if m == "pelvistim_fem_tpu" or m.startswith("pelvistim_fem_tpu.")]
assert not bad, bad
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=Path(__file__).resolve().parents[1],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
