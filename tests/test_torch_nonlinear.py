"""PyTorch port: field-dependent and temperature-coupled conductivity
(ops/nonlinear) and the lattice pieces they use (lattice_cell_e_mag, the
sigma_cell branch of lattice_coeff) against the JAX package's, on the
CPU.

The reference tests' two-layer column (current mode, full-face
electrodes) carries the element and lattice fixed points; one coarse
step04 contact level carries the app's lattice path.  Tolerances: both
packages certify phi to a true f64 residual of 1e-8, so potentials and
conductivities agree to ~1e-7 relative; the Picard pass counts follow
rounding (the secant fixed point is chaotic: on the step04 skin law the
two packages agree to 4 digits for 7 passes, then part), so they are
compared only where the fixed point is contractive (the column, amp = 0).
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.mesh import core as jcore  # noqa: E402
from pelvistim_fem_tpu.mesh.generate import (  # noqa: E402
    LatticeRecipe as JRecipe, build_mesh_from_lattice as jbuild_mesh)
from pelvistim_fem_tpu.mesh.spec import \
    build_lattice_spec as jbuild_spec  # noqa: E402
from pelvistim_fem_tpu.models.case import \
    build_case as jbuild_case  # noqa: E402
from pelvistim_fem_tpu.ops import bioheat as jbh  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import nonlinear as jnl  # noqa: E402
from pelvistim_fem_tpu.ops.metrics import \
    compliance_voltage as jcompliance_voltage  # noqa: E402

from pelvistim_fem_tpu_torch.mesh import core  # noqa: E402
from pelvistim_fem_tpu_torch.mesh.generate import (  # noqa: E402
    LatticeRecipe, build_mesh_from_lattice)
from pelvistim_fem_tpu_torch.mesh.spec import \
    build_lattice_spec  # noqa: E402
from pelvistim_fem_tpu_torch.models.case import build_case  # noqa: E402
from pelvistim_fem_tpu_torch.ops import bioheat as bh  # noqa: E402
from pelvistim_fem_tpu_torch.ops import lattice_assembly as la  # noqa: E402
from pelvistim_fem_tpu_torch.ops import nonlinear as nl  # noqa: E402
from pelvistim_fem_tpu_torch.ops.metrics import \
    compliance_voltage  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

L_XY = 0.02
DA = DB = 0.01
# the reference tests' laws: the column's and a lattice-scale one
COLUMN_LAW = dict(amp_by_body={2: 4.0}, e0_by_body={2: 20_000.0},
                  w_by_body={2: 4_000.0})
LATTICE_LAW = dict(amp_by_body={2: 3.0}, e0_by_body={2: 40.0},
                   w_by_body={2: 10.0})
SIGMAS = {1: 0.35, 2: 0.05}


def _column_fns(c):
    def body_fn(cx, cy, cz):
        return np.where(cz < DA, 1, 2).astype(np.int32)

    def bcid_fn(fx, fy, fz, nx, ny, nz):
        out = np.full(fx.shape, c.BC_INSULATED, np.int32)
        out[(nz > 0.5) & (np.abs(fz - (DA + DB)) < 1e-9)] = c.BC_ACTIVE
        out[(nz < -0.5) & (np.abs(fz) < 1e-9)] = c.BC_RETURN
        return out

    return body_fn, bcid_fn


def _axes(h):
    xs = np.linspace(0, L_XY, int(L_XY / h) + 1)
    return xs, xs, np.linspace(0, DA + DB, int((DA + DB) / h) + 1)


def _column(h, current=1.0):
    """(port Case, reference Case) of the two-layer column, f64."""
    tcase = build_case(build_mesh_from_lattice(*_axes(h), *_column_fns(core)),
                       SIGMAS, mode="current", injected_current_A=current,
                       dtype=torch.float64, device="cpu")
    jcase = jbuild_case(jbuild_mesh(*_axes(h), *_column_fns(jcore)), SIGMAS,
                        mode="current", injected_current_A=current,
                        dtype=jnp.float64)
    return tcase, jcase


def _specs(h, **kw):
    return (build_lattice_spec(LatticeRecipe(*_axes(h), *_column_fns(core)),
                               SIGMAS, **kw),
            jbuild_spec(JRecipe(*_axes(h), *_column_fns(jcore)), SIGMAS,
                        **kw))


def _laws(law_kw, n_bodies=2):
    return (nl.field_law(SIGMAS, n_bodies=n_bodies, device="cpu", **law_kw),
            jnl.field_law(SIGMAS, n_bodies=n_bodies, **law_kw))


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def test_law_sigma_matches_reference():
    tlaw, jlaw = _laws(COLUMN_LAW)
    for f in dataclasses.fields(tlaw):
        assert np.array_equal(getattr(tlaw, f.name).numpy(),
                              np.asarray(getattr(jlaw, f.name))), f.name
    rng = np.random.default_rng(5)
    body = rng.integers(1, 3, 200)
    e = 4e4 * rng.random(200)
    got = nl.law_sigma(tlaw, torch.as_tensor(body), torch.as_tensor(e))
    want = jnl.law_sigma(jlaw, jnp.asarray(body), jnp.asarray(e))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=0)
    # rebased: sigma(0) = sigma0 exactly
    zero = nl.law_sigma(tlaw, torch.as_tensor(body),
                        torch.zeros(200, dtype=torch.float64))
    assert np.array_equal(zero.numpy(),
                          np.array([SIGMAS[b] for b in body]))


def test_lattice_cell_e_mag_exact_and_matches_reference():
    """An exact linear potential phi = 3 z + 0.25 gives |grad phi| = 3 on
    every Kuhn class cell; a random field matches the reference to f64
    round-off."""
    spec, jspec = _specs(0.005, mode="voltage", active_V=1.0)
    dev = la.spec_device_arrays(spec, torch.float64, "cpu")
    jdev = jla.spec_device_arrays(jspec, jnp.float64)
    X, Y, Z = spec.grid_shape
    zgrid = np.broadcast_to(np.asarray(spec.axes[2])[None, None, :],
                            (X, Y, Z))
    e = la.lattice_cell_e_mag(dev["h_axes"], dev["coords_dev"],
                              torch.as_tensor(3.0 * zgrid + 0.25))
    assert e.shape == (6, X - 1, Y - 1, Z - 1)
    np.testing.assert_allclose(e.numpy(), 3.0, rtol=1e-12)
    phi = np.random.default_rng(2).standard_normal((X, Y, Z))
    got = la.lattice_cell_e_mag(dev["h_axes"], dev["coords_dev"],
                                torch.as_tensor(phi))
    want = jla.lattice_cell_e_mag(jdev["h_axes"], jdev["coords_dev"],
                                  jnp.asarray(phi))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=0)


def test_lattice_sigma_cell_matches_table_and_reference():
    """lattice_coeff(sigma_cell=table[body6]) is the pre-combined
    sigma_table stack exactly, and a random per-cell field gives the
    reference's stack to f64 round-off."""
    spec, jspec = _specs(0.005, mode="current", injected_current_A=1.0)
    dev = la.spec_device_arrays(spec, torch.float64, "cpu")
    args = (dev["h_axes"], dev["coords_dev"], dev["body6"], spec.n_bodies)
    body = dev["body6"].to(torch.int64)
    c_tab = la.lattice_coeff(*args, sigma_table=dev["sigma_table"])
    c_cell = la.lattice_coeff(*args, sigma_cell=torch.where(
        body == 0, 0.0, dev["sigma_table"][body]))
    assert c_cell.shape == (1, 27) + spec.grid_shape
    assert torch.equal(c_tab, c_cell)
    with pytest.raises(ValueError):
        la.lattice_coeff(*args, sigma_table=dev["sigma_table"],
                         sigma_cell=c_cell)

    sig = np.random.default_rng(4).random(tuple(body.shape)) + 0.5
    sig[np.asarray(spec.body6) == 0] = 0.0
    jdev = jla.spec_device_arrays(jspec, jnp.float64)
    want = jla.lattice_coeff(jdev["h_axes"], jdev["coords_dev"],
                             jdev["body6"], jspec.n_bodies,
                             sigma_cell=jnp.asarray(sig))
    got = la.lattice_coeff(*args, sigma_cell=torch.as_tensor(sig))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-13 * float(np.abs(want).max()))


def test_linear_reduction():
    """amp = 0: the element fixed point is the linear certified solve,
    in one Picard pass with zero change, as in the reference."""
    from pelvistim_fem_tpu_torch.ops.solve import solve_case_refined
    tcase, _ = _column(0.0025)
    tlaw, _ = _laws({})
    res = nl.solve_case_field_dependent(tcase, tlaw)
    ref = solve_case_refined(tcase, tol=1e-8)
    assert _rel(res.phi, ref.phi) < 1e-7
    assert bool(res.converged) and float(res.residual) <= 1e-8
    assert int(res.picard_iters) == 1 and float(res.sigma_change) == 0.0


def test_column_field_dependent_matches_reference():
    """The column's element fixed point against the reference's: phi,
    the converged sigma and the compliance voltage; certified."""
    tcase, jcase = _column(0.0025)
    tlaw, jlaw = _laws(COLUMN_LAW)
    res = nl.solve_case_field_dependent(tcase, tlaw)
    ref = jnl.solve_case_field_dependent(jcase, jlaw)
    assert bool(res.converged) and float(res.residual) <= 1e-8
    assert _rel(res.phi, ref.phi) < 1e-7
    np.testing.assert_allclose(res.sigma_e.numpy(), np.asarray(ref.sigma_e),
                               rtol=1e-6)
    assert abs(int(res.picard_iters) - int(ref.picard_iters)) <= 1
    np.testing.assert_allclose(compliance_voltage(tcase, res.phi),
                               jcompliance_voltage(jcase, ref.phi),
                               rtol=1e-7)


def test_lattice_field_dependent_matches_element_and_reference():
    """The lattice fixed point (per-cell re-assembly, frozen MG
    preconditioner) against the element path's compliance voltage and
    the reference's lattice solve: certified, phi within 1e-7, sigma
    within 1e-6."""
    tcase, _ = _column(0.005)
    tlaw, jlaw = _laws(LATTICE_LAW)
    elem = nl.solve_case_field_dependent(tcase, tlaw)
    spec, jspec = _specs(0.005, mode="current", injected_current_A=1.0)
    res = nl.solve_lattice_field_dependent(spec, tlaw, device="cpu")
    ref = jnl.solve_lattice_field_dependent(jspec, jlaw)
    assert bool(res.converged) and float(res.residual) <= 1e-8
    assert res.sigma_e.shape == (6,) + tuple(n - 1 for n in spec.grid_shape)
    np.testing.assert_allclose(compliance_voltage(tcase, res.phi),
                               compliance_voltage(tcase, elem.phi),
                               rtol=1e-6)
    assert _rel(res.phi, ref.phi) < 1e-7
    np.testing.assert_allclose(res.sigma_e.numpy(), np.asarray(ref.sigma_e),
                               rtol=1e-6, atol=0)


def test_step04_lattice_level_matches_reference():
    """One coarse step04 contact level (sigma_contact 5.01e-3 S/m, the
    middle of the app's 15) through solve_lattice_field_dependent with
    the app's skin-only law at amp 0.5 and width 2000 V/m: a law whose
    fixed point takes ~20 passes here (the app's amp 4, width 500 takes
    100-230 on this mesh, whose count follows rounding, and minutes on
    the CPU; chip_smoke holds the app's law at full size on the card).
    Compliance voltage and skin sigma rise within 1e-6 of the
    reference's."""
    from pelvistim_fem_tpu.models.pressure import \
        build_pressure_spec as jpressure_spec
    from pelvistim_fem_tpu_torch.models.pressure import (build_pressure_case,
                                                         build_pressure_spec,
                                                         sigma_tables)
    spec, p = build_pressure_spec(coarse=True)
    jspec, _ = jpressure_spec(coarse=True)
    level = 7
    tab = sigma_tables(spec, p["pressure_sweep"]["sigma_contact_Spm"])[level]
    n = spec.n_bodies + 1
    amp, e0, w = np.zeros(n), np.ones(n), np.ones(n)
    amp[core.BODY_SKIN], e0[core.BODY_SKIN], w[core.BODY_SKIN] = \
        0.5, 2000.0, 2000.0
    f = lambda a: torch.as_tensor(a, dtype=torch.float64)
    res = nl.solve_lattice_field_dependent(
        spec, nl.FieldLaw(f(tab), f(amp), f(e0), f(w)), device="cpu")
    ref = jnl.solve_lattice_field_dependent(
        jspec, jnl.FieldLaw(*(jnp.asarray(a) for a in (tab, amp, e0, w))))
    assert bool(res.converged) and float(res.residual) <= 1e-8
    assert bool(np.asarray(ref.converged))
    case, _ = build_pressure_case(p, coarse=True, device="cpu")
    np.testing.assert_allclose(compliance_voltage(case, res.phi),
                               compliance_voltage(case, torch.as_tensor(
                                   np.array(ref.phi))), rtol=1e-6)
    skin6 = np.asarray(spec.body6) == core.BODY_SKIN
    rise = res.sigma_e.numpy()[skin6].mean() / tab[core.BODY_SKIN]
    jrise = np.asarray(ref.sigma_e)[skin6].mean() / tab[core.BODY_SKIN]
    assert rise > 1.05
    np.testing.assert_allclose(rise, jrise, rtol=1e-6)


@pytest.mark.parametrize("alpha", [0.0, 0.015])
def test_electrothermal_matches_reference(alpha):
    """The coupled sigma(T) fixed point on the column (0.05 A, 1% duty,
    a uniform-37 degC baseline) against the reference's: phi, T and
    sigma; alpha = 0 is the uncoupled solve in one pass."""
    tcase, jcase = _column(0.0025, current=0.05)
    kt, pt = bh.thermal_tables(2, {1: 0.49, 2: 0.37},
                               {1: 2700.0, 2: 7400.0})
    tb = bh.build_bioheat_case(tcase, kt, pt, T_core=37.0, T_air=37.0)
    jb = jbh.build_bioheat_case(jcase, kt, pt, T_core=37.0, T_air=37.0)
    a = np.array([0.0, alpha, alpha])
    relax = 1.0 if alpha == 0.0 else 0.8
    res = nl.solve_case_electrothermal(tcase, tb, tcase.sigma_table,
                                       torch.as_tensor(a), duty=0.01,
                                       relax=relax)
    ref = jnl.solve_case_electrothermal(jcase, jb, jcase.sigma_table,
                                        jnp.asarray(a), duty=0.01,
                                        relax=relax)
    assert bool(res.converged) and float(res.residual) <= 1e-8
    assert float(res.residual_T) <= 1e-9
    assert int(res.picard_iters) == int(ref.picard_iters)
    if alpha == 0.0:
        assert int(res.picard_iters) == 1
    assert _rel(res.phi, ref.phi) < 1e-7
    np.testing.assert_allclose(res.T.numpy(), np.asarray(ref.T), rtol=0,
                               atol=1e-8)
    np.testing.assert_allclose(res.sigma_e.numpy(), np.asarray(ref.sigma_e),
                               rtol=1e-9)
