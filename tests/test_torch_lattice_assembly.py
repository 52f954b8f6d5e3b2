"""PyTorch port: device lattice assembly, the Galerkin hierarchy, the
multigrid transfers and the certified single-operator solve, against
the JAX package on the coarse step04 lattice (25, 14, 13), 5 bodies."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models.pressure import \
    build_pressure_spec as jax_pressure_spec  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import multigrid as jmg  # noqa: E402

from pelvistim_fem_tpu_torch.models.pressure import \
    build_pressure_spec  # noqa: E402
from pelvistim_fem_tpu_torch.ops import lattice_assembly as tla  # noqa: E402
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401


def _close64(got, ref):
    """f64 parity: rtol 1e-12, plus atol 1e-12 max|ref| for entries that
    cancel to roundoff (stencil entries that are zero in exact
    arithmetic)."""
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())


@pytest.fixture(scope="module")
def coarse():
    jspec, _ = jax_pressure_spec(coarse=True)
    tspec, _ = build_pressure_spec(coarse=True)
    jcase, jhier = jla.assemble_lattice(jspec, jnp.float64)
    tcase, thier = tla.assemble_lattice(tspec, torch.float64, device="cpu")
    return dict(jspec=jspec, tspec=tspec, jcase=jcase, jhier=jhier,
                tcase=tcase, thier=thier)


def test_lattice_coeff_per_body(coarse):
    assert coarse["tcase"].coeff.shape == (5, 27, 25, 14, 13)
    _close64(coarse["tcase"].coeff.numpy(), coarse["jcase"].coeff)


def test_lattice_coeff_precombined_sigma_table(coarse):
    """The scalar sigma_table branch (pre-combined B == 1 stack) used by
    the single-operator solve."""
    spec = coarse["tspec"]
    jdev = jla.spec_device_arrays(coarse["jspec"], jnp.float64)
    tdev = tla.spec_device_arrays(spec, torch.float64, "cpu")
    ref = jla.lattice_coeff(jdev["h_axes"], jdev["coords_dev"],
                            jdev["body6"], spec.n_bodies,
                            sigma_table=jdev["sigma_table"])
    got = tla.lattice_coeff(tdev["h_axes"], tdev["coords_dev"],
                            tdev["body6"], spec.n_bodies,
                            sigma_table=tdev["sigma_table"])
    assert got.shape == (1, 27, 25, 14, 13)
    _close64(got.numpy(), ref)


@pytest.mark.parametrize("level", [0, 1, 2, 3])
def test_hierarchy_level_matches(coarse, level):
    """Every Galerkin-probed level: coefficients to f64 roundoff, free
    masks exactly."""
    jl, tl = coarse["jhier"].levels, coarse["thier"].levels
    assert len(tl) == len(jl) == 4
    _close64(tl[level].coeff.numpy(), jl[level].coeff)
    np.testing.assert_array_equal(tl[level].free.numpy(),
                                  np.asarray(jl[level].free))


def test_case_grids_match(coarse):
    jc, tc = coarse["jcase"], coarse["tcase"]
    for name in ("free", "dirichlet", "b_neumann", "grid_index",
                 "sigma_table"):
        np.testing.assert_array_equal(getattr(tc, name).numpy(),
                                      np.asarray(getattr(jc, name)),
                                      err_msg=name)
    assert tc.grid_index.dtype == torch.int64


@pytest.mark.parametrize("lead", [(), (3,)])
def test_transfers_match_reference(coarse, lead):
    """Prolongation and the deterministic gather-form restriction vs the
    reference's device transfers (scatter-add restriction)."""
    axes = coarse["tspec"].axes
    jc_axes, jpro, jres = jmg.make_transfers(axes)
    tr = tmg.Transfer(axes)
    for a, b in zip(jc_axes, tr.coarse_axes):
        np.testing.assert_array_equal(a, b)
    rng = np.random.default_rng(7)
    xc = rng.standard_normal(lead + tr.nc)
    xf = rng.standard_normal(lead + tr.fine_shape)
    _close64(tr.prolong(torch.as_tensor(xc)).numpy(),
             jpro(jnp.asarray(xc)))
    _close64(tr.restrict(torch.as_tensor(xf)).numpy(),
             jres(jnp.asarray(xf)))


def test_restrict_is_prolong_transpose(coarse):
    tr = tmg.Transfer(coarse["tspec"].axes)
    rng = np.random.default_rng(8)
    xc = torch.as_tensor(rng.standard_normal(tr.nc))
    xf = torch.as_tensor(rng.standard_normal(tr.fine_shape))
    lhs = float(torch.sum(tr.restrict(xf) * xc))
    rhs = float(torch.sum(xf * tr.prolong(xc)))
    assert abs(lhs - rhs) <= 1e-12 * abs(rhs)


def test_assemble_lattice_defaults_to_the_card(coarse):
    """With no device the assembly goes to the card: without one it
    raises rather than return CPU tensors."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tla.assemble_lattice(coarse["tspec"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tla.solve_lattice_mg_refined(coarse["tspec"])


def test_solve_lattice_mg_refined_matches_reference(coarse):
    """The megatet leg's entry point on the coarse lattice: certified
    true residual, iterations within 2, phi within 1e-6 max|phi|."""
    ref = jla.solve_lattice_mg_refined(coarse["jspec"], tol=1e-8)
    got = tla.solve_lattice_mg_refined(coarse["tspec"], tol=1e-8,
                                       device="cpu")
    assert bool(got.converged) and float(got.residual) <= 1e-8
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    p_ref = np.asarray(ref.phi)
    assert got.phi.shape == p_ref.shape
    np.testing.assert_allclose(got.phi.numpy(), p_ref, rtol=0,
                               atol=1e-6 * np.abs(p_ref).max())
