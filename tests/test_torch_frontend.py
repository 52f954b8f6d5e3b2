"""PyTorch port: the numpy host front end equals the JAX package's, and
the port imports neither JAX, YAML nor the JAX package."""

import dataclasses
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

pytest.importorskip("torch")

import yaml  # noqa: E402

from pelvistim_fem_tpu.mesh import grading as jgrading  # noqa: E402
from pelvistim_fem_tpu.models.ankle import \
    build_layered_spec as jax_layered_spec  # noqa: E402
from pelvistim_fem_tpu.models.pressure import \
    build_pressure_spec as jax_pressure_spec  # noqa: E402
from pelvistim_fem_tpu.utils import config as jconfig  # noqa: E402

from pelvistim_fem_tpu_torch.mesh import grading  # noqa: E402
from pelvistim_fem_tpu_torch.models.ankle import \
    build_layered_spec  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    build_pressure_spec, log_spaced_contacts, sigma_tables, sweep_spec)
from pelvistim_fem_tpu_torch.utils import config  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "pelvistim_fem_tpu_torch"


def _assert_specs_equal(a, b):
    for f in dataclasses.fields(a):
        x, y = getattr(a, f.name), getattr(b, f.name)
        if isinstance(x, tuple):
            assert len(x) == len(y), f.name
            for u, v in zip(x, y):
                assert np.array_equal(u, v) and u.dtype == v.dtype, f.name
        elif isinstance(x, np.ndarray):
            assert np.array_equal(x, y) and x.dtype == y.dtype, f.name
        else:
            assert x == y, f.name


@pytest.mark.parametrize("step", ["step01_box", "step02_electrodes",
                                  "step03_ankle_layers", "step04_pressure"])
def test_json_params_equal_yaml(step):
    path = ROOT / "pelvistim_fem_tpu" / "data" / f"{step}.yaml"
    with open(path) as f:
        ref = yaml.safe_load(f)
    assert config.default_params(step) == ref
    assert config.default_params(step) == jconfig.default_params(step)


def test_merge_params_matches_reference():
    base = config.default_params("step04_pressure")
    over = {"mesh": {"rim_refine": 2.0}, "contact": {"enabled": False}}
    assert config.merge_params(base, over) == jconfig.merge_params(base,
                                                                   over)
    assert "rim_refine" not in base["mesh"]


def test_pressure_spec_equals_reference():
    _assert_specs_equal(build_pressure_spec(coarse=True)[0],
                        jax_pressure_spec(coarse=True)[0])


def test_pressure_spec_rim_bands_equals_reference():
    """The sweep leg's rim-banded mesh option, at coarse spacing."""
    p = config.default_params("step04_pressure")
    p["mesh"]["rim_refine"] = 2.0
    _assert_specs_equal(build_pressure_spec(p, coarse=True)[0],
                        jax_pressure_spec(p, coarse=True)[0])


def test_layered_spec_equals_reference():
    _assert_specs_equal(build_layered_spec(coarse=True)[0],
                        jax_layered_spec(coarse=True)[0])


def test_ankle_cross_section_spec_equals_reference():
    """The deformed ankle outline (carving + z-deformation)."""
    p = config.default_params("step03_ankle_layers")
    p["geometry"]["cross_section"] = "ankle"
    _assert_specs_equal(build_layered_spec(p, coarse=True)[0],
                        jax_layered_spec(p, coarse=True)[0])


@pytest.mark.parametrize("regions", [
    [(0.01, 0.02)],
    [(0.005, 0.03), (0.02, 0.05, 0.0005)],
    [(-0.01, 0.002), (0.07, 0.09)],
])
def test_graded_axis_equals_reference(regions):
    a = grading.graded_axis(0.0, 0.08, regions, 0.0015, 0.003)
    b = jgrading.graded_axis(0.0, 0.08, regions, 0.0015, 0.003)
    assert np.array_equal(a, b)
    assert np.array_equal(grading.layered_z_axis([0, 0.03, 0.04],
                                                 [0.003, 0.0005]),
                          jgrading.layered_z_axis([0, 0.03, 0.04],
                                                  [0.003, 0.0005]))


def test_sweep_tables():
    """The benchmark's 100 log-spaced contact lanes (bench.py)."""
    spec, params = build_pressure_spec(coarse=True)
    sweep = params["pressure_sweep"]["sigma_contact_Spm"]
    sig = log_spaced_contacts(params, 100)
    np.testing.assert_array_equal(
        sig, np.logspace(np.log10(sweep[0]), np.log10(sweep[-1]), 100))
    tabs = sigma_tables(spec, sig)
    assert tabs.shape == (100, 6)
    np.testing.assert_array_equal(tabs[:, 4], sig)
    np.testing.assert_array_equal(tabs[:, 5], sig)
    np.testing.assert_array_equal(tabs[:, :4],
                                  np.tile(spec.sigma_table[:4], (100, 1)))


def test_sweep_leg_spec_equals_reference():
    """The benchmark's sweep leg (bench.py): the full-size rim-banded
    lattice and its 100 contact lanes."""
    spec, params, tabs = sweep_spec()
    p = jconfig.default_params("step04_pressure")
    p.setdefault("mesh", {})["rim_refine"] = 2.0
    _assert_specs_equal(spec, jax_pressure_spec(p)[0])
    assert spec.grid_shape == (89, 41, 19) and len(spec.grid_index) == 66228
    np.testing.assert_array_equal(
        tabs, sigma_tables(spec, log_spaced_contacts(params, 100)))


def test_port_sources_import_no_jax_yaml_or_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|yaml|pelvistim_fem_tpu)\b",
                     re.M)
    for path in list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]:
        hits = pat.findall(path.read_text())
        assert not hits, f"{path}: {hits}"


def test_port_runs_without_jax_or_yaml():
    """In a process where jax and yaml cannot be imported, the port
    imports and runs a coarse certified solve on the CPU."""
    code = """
import sys
sys.modules["jax"] = None
sys.modules["yaml"] = None
import pelvistim_fem_tpu_torch
from pelvistim_fem_tpu_torch.models.pressure import build_pressure_spec
from pelvistim_fem_tpu_torch.ops.lattice_assembly import (
    solve_lattice_mg_refined)
import pelvistim_fem_tpu_torch.interop
import pelvistim_fem_tpu_torch.ops.multigrid
import pelvistim_fem_tpu_torch.roofline_probe
import pelvistim_fem_tpu_torch.spmv_kernels_ab
import pelvistim_fem_tpu_torch.apps.run_array_opt
import pelvistim_fem_tpu_torch.apps.run_calibration
import pelvistim_fem_tpu_torch.ops.adjoint
import pelvistim_fem_tpu_torch.ops.aniso
import pelvistim_fem_tpu_torch.ops.calibrate
import pelvistim_fem_tpu_torch.apps.smoke_test
import pelvistim_fem_tpu_torch.models.array
import pelvistim_fem_tpu_torch.ops.leadfield
import pelvistim_fem_tpu_torch.ops.uq
import pelvistim_fem_tpu_torch.apps.crossval_elmer
import pelvistim_fem_tpu_torch.apps.meshtool
import pelvistim_fem_tpu_torch.apps.run_step03
import pelvistim_fem_tpu_torch.mesh.io_elmer
import pelvistim_fem_tpu_torch.mesh.io_msh
import pelvistim_fem_tpu_torch.mesh.refine
import pelvistim_fem_tpu_torch.models.imported
import pelvistim_fem_tpu_torch.ops.amg
import pelvistim_fem_tpu_torch.ops.estimate
import pelvistim_fem_tpu_torch.ops.stencil_estimate
import pelvistim_fem_tpu_torch.utils.sif
import pelvistim_fem_tpu_torch.utils.vtu
spec, _ = build_pressure_spec(coarse=True)
r = solve_lattice_mg_refined(spec, tol=1e-8, device="cpu")
assert bool(r.converged) and float(r.residual) <= 1e-8, r
bad = [m for m in sys.modules
       if m == "pelvistim_fem_tpu" or m.startswith("pelvistim_fem_tpu.")]
assert not bad, bad
print("ok", int(r.iterations))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")
