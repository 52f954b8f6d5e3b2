"""PyTorch port: the Adam fit of ops/calibrate against the JAX package's
(optax.adam), f64 on the CPU, on the layered slab of
tests/test_adjoint.py:103-132: muscle and fat recovered within 2% in 160
steps, the first 20 losses on the reference's trajectory, the other
slots untouched."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.mesh.generate import \
    layered_slab_recipe as jax_slab  # noqa: E402
from pelvistim_fem_tpu.mesh.spec import \
    build_lattice_spec as jax_lattice_spec  # noqa: E402
from pelvistim_fem_tpu.ops import adjoint as jadj  # noqa: E402
from pelvistim_fem_tpu.ops import calibrate as jcal  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402

from pelvistim_fem_tpu_torch.mesh import core  # noqa: E402
from pelvistim_fem_tpu_torch.mesh.generate import \
    layered_slab_recipe  # noqa: E402
from pelvistim_fem_tpu_torch.mesh.spec import \
    build_lattice_spec  # noqa: E402
from pelvistim_fem_tpu_torch.ops import calibrate  # noqa: E402
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

SLAB = dict(layers=[(core.BODY_MUSCLE, 0.0105, 0.006),
                    (core.BODY_FAT, 0.002, 0.002),
                    (core.BODY_SKIN, 0.0015, 0.0015)],
            electrodes=[(0.0075, 0.018, 0.004), (0.0225, 0.018, 0.004)],
            contact_t=0.001, contact_h_z=0.001, h_fine=0.005,
            h_coarse=0.01)
SIG5 = {1: 0.35, 2: 0.04, 3: 1e-3, 4: 5e-3, 5: 5e-3}
BODIES = (1, 2)                          # muscle, fat
STEPS, HISTORY = 160, 20


def test_adam_recovers_muscle_and_fat_on_the_reference_trajectory():
    jspec = jax_lattice_spec(jax_slab(0.03, 0.024, 0.014, **SLAB), SIG5,
                             mode="current", injected_current_A=5e-3)
    jc, jh = jla.assemble_lattice(jspec, jnp.float64)
    truth = np.asarray(jspec.sigma_table, np.float64)
    phi = np.asarray(jadj.solve_stencil_mg_diff(jc, jh, jnp.asarray(truth),
                                                tol=1e-10))
    obs_idx = np.arange(0, phi.shape[0], 5)
    sigma0 = np.array([2.5 * SIG5[1], 0.4 * SIG5[2]])
    _, jloss = jcal.calibrate_sigma(
        jc, jh, jnp.asarray(obs_idx, jnp.int32), jnp.asarray(phi[obs_idx]),
        BODIES, jnp.asarray(sigma0), steps=HISTORY, lr=0.1, tol=1e-9)

    spec = build_lattice_spec(layered_slab_recipe(0.03, 0.024, 0.014,
                                                  **SLAB), SIG5,
                              mode="current", injected_current_A=5e-3)
    sc, h = assemble_lattice(spec, torch.float64, device="cpu")
    stats = []
    fit, loss = calibrate.calibrate_sigma(
        sc, h, torch.as_tensor(obs_idx), torch.as_tensor(phi[obs_idx]),
        BODIES, torch.as_tensor(sigma0), steps=STEPS, lr=0.1, tol=1e-9,
        stats=stats)
    fit, loss = fit.numpy(), loss.numpy()
    assert loss.shape == (STEPS,) and loss[-1] < 1e-7
    np.testing.assert_allclose(loss[:HISTORY], np.asarray(jloss), rtol=1e-6)
    np.testing.assert_allclose(fit[1], SIG5[1], rtol=0.02)
    np.testing.assert_allclose(fit[2], SIG5[2], rtol=0.02)
    np.testing.assert_array_equal(fit[3:], truth[3:])
    assert [k for k, _ in stats] == ["forward", "adjoint"] * STEPS
