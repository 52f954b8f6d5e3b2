"""PyTorch port: conductivity calibration (ops/calibrate) against the JAX
package, f64 on the CPU: the Levenberg-Marquardt fit of muscle, fat and
skin on the coarse step04 lattice (recovery, loss history, untouched
slots) and its small unrolled Cholesky solve.  Adam, the slower loop on
the CPU, is in tests/test_torch_calibrate_adam.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models.pressure import \
    build_pressure_spec as jax_pressure_spec  # noqa: E402
from pelvistim_fem_tpu.ops import adjoint as jadj  # noqa: E402
from pelvistim_fem_tpu.ops import calibrate as jcal  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402

from pelvistim_fem_tpu_torch.models.pressure import \
    build_pressure_spec  # noqa: E402
from pelvistim_fem_tpu_torch.ops import calibrate  # noqa: E402
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

BODIES = (1, 2, 3)                       # muscle, fat, skin
OFF = np.array([2.5, 0.4, 3.0])          # the literature-uncertainty start
LM_ITERS = 8


@pytest.fixture(scope="module")
def lm():
    """The reference's and the port's LM fits on the coarse step04
    lattice from the same observations (every third node of the
    reference's synthesis solve at tol 1e-10), LM_ITERS iterations at
    tol 1e-9; the port's solves' (kind, iterations)."""
    jspec, _ = jax_pressure_spec(coarse=True)
    jc, jh = jla.assemble_lattice(jspec, jnp.float64)
    truth = np.asarray(jspec.sigma_table, np.float64)
    phi = np.asarray(jadj.solve_stencil_mg_diff(jc, jh, jnp.asarray(truth),
                                                tol=1e-10))
    obs_idx = np.arange(0, phi.shape[0], 3)
    sigma0 = truth[list(BODIES)] * OFF
    jfit, jloss = jcal.calibrate_sigma_lm(
        jc, jh, jnp.asarray(obs_idx, jnp.int32), jnp.asarray(phi[obs_idx]),
        BODIES, jnp.asarray(sigma0), iters=LM_ITERS, tol=1e-9)
    spec, _ = build_pressure_spec(coarse=True)
    sc, h = assemble_lattice(spec, torch.float64, device="cpu")
    stats = []
    fit, loss = calibrate.calibrate_sigma_lm(
        sc, h, torch.as_tensor(obs_idx), torch.as_tensor(phi[obs_idx]),
        BODIES, torch.as_tensor(sigma0), iters=LM_ITERS, tol=1e-9,
        stats=stats)
    return dict(truth=truth, fit=fit.numpy(), loss=loss.numpy(),
                jfit=np.asarray(jfit), jloss=np.asarray(jloss), stats=stats)


def test_lm_recovers_the_tissue_set(lm):
    """Each fitted slot within rtol 1e-6 of the truth; the slots not
    fitted exactly at the table's values."""
    for b in BODIES:
        np.testing.assert_allclose(lm["fit"][b], lm["truth"][b], rtol=1e-6)
    np.testing.assert_array_equal(lm["fit"][4:], lm["truth"][4:])
    assert lm["fit"][0] == lm["truth"][0]
    np.testing.assert_allclose(lm["fit"], lm["jfit"], rtol=1e-6)


def test_lm_loss_history_matches_reference(lm):
    """The loss history within rtol 1e-4 of the reference's while it is
    above 1e-14 (below, both are solver rounding)."""
    jl, loss = lm["jloss"], lm["loss"]
    assert loss.shape == jl.shape == (LM_ITERS,)
    held = jl > 1e-14
    assert held.sum() >= 5
    np.testing.assert_allclose(loss[held], jl[held], rtol=1e-4)
    assert loss[-1] < 1e-14


def test_lm_solves_per_iteration(lm):
    """One cold solve at the start, then per iteration one primal (warm:
    zero CG iterations, it starts at the last accepted solution), three
    tangent solves and one trial solve."""
    kinds = [k for k, _ in lm["stats"]]
    assert kinds == ["forward"] + LM_ITERS * (
        ["forward", "tangent"] * 3 + ["forward"])
    its = [n for _, n in lm["stats"]]
    assert its[0] > 0
    assert all(its[1 + 7 * i] == 0 for i in range(LM_ITERS))
    assert all(n > 0 for k, n in lm["stats"] if k == "tangent")


def test_spd_solve_small_matches_numpy():
    rng = np.random.default_rng(3)
    for n in (1, 2, 3, 5):
        M = rng.standard_normal((n, n))
        A = M @ M.T + n * np.eye(n)
        b = rng.standard_normal(n)
        x = calibrate._spd_solve_small(torch.as_tensor(A), torch.as_tensor(b))
        np.testing.assert_allclose(x.numpy(), np.linalg.solve(A, b),
                                   rtol=1e-12)
