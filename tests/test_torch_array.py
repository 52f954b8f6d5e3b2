"""PyTorch port: the electrode-array front end (models/array, ops/uq)
equals the JAX package's, and the port's sweep of sigma tables with a
load per lane (multigrid.batched_mg_solve_refined, the lead-field
ensemble's solve) agrees with the reference's vmapped per-lane solves.

The solvers run on the JAX-assembled case and hierarchy, handed over as
numpy arrays (pelvistim_fem_tpu_torch.interop), on the reference test's
tiny array: a (18, 18, 9) lattice with K = 4 discs."""

import dataclasses
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models import array as jarray  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import leadfield as jlf  # noqa: E402
from pelvistim_fem_tpu.ops import multigrid as jmg  # noqa: E402
from pelvistim_fem_tpu.ops import uq as juq  # noqa: E402

from pelvistim_fem_tpu_torch import interop  # noqa: E402
from pelvistim_fem_tpu_torch.mesh import core  # noqa: E402
from pelvistim_fem_tpu_torch.models import array as tarray  # noqa: E402
from pelvistim_fem_tpu_torch.ops import leadfield as tlf  # noqa: E402
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402
from pelvistim_fem_tpu_torch.ops import uq as tuq  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_leadfield import _tiny_params  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

TOL = 1e-10
GSD = {core.BODY_MUSCLE: 1.35, core.BODY_FAT: 1.6, core.BODY_SKIN: 2.0}


def _params(name):
    if name == "tiny":
        return _tiny_params()
    return tarray.default_array_params(coarse=name == "coarse")


@pytest.mark.parametrize("name", ["tiny", "coarse", "full"])
def test_array_specs_equal_reference(name):
    """Every spec of the K-disc ring is bit-identical to the JAX
    package's (the full size is the app's --full lattice, (71, 71,
    24))."""
    specs, params, meta = tarray.build_array_specs(_params(name))
    jspecs, jparams, jmeta = jarray.build_array_specs(_params(name))
    assert params == jparams and len(specs) == len(jspecs)
    for s, j in zip(specs, jspecs):
        assert s.grid_shape == j.grid_shape
        for f in ("body6", "free", "coords_dev", "b_neumann",
                  "sigma_table", "dirichlet", "grid_index"):
            a, b = np.asarray(getattr(s, f)), np.asarray(getattr(j, f))
            assert a.dtype == b.dtype and np.array_equal(a, b), f
    for k in meta:
        np.testing.assert_array_equal(meta[k], jmeta[k])
    if name == "full":
        assert specs[0].grid_shape == (71, 71, 24)


def test_array_mesh_equals_reference():
    """The element mesh of the tiny ring (lead extraction) equals the
    reference's, node for node."""
    p = _tiny_params()
    a = tarray.array_recipe(p, 1).mesh()
    b = jarray.array_recipe(p, 1).mesh()
    for f in ("nodes", "tets", "tet_body", "faces", "face_bcid"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), f)


@pytest.mark.parametrize("seed", [0, 3])
def test_sample_sigma_tables_equal_reference(seed):
    nominal = np.asarray(tarray.build_array_specs(_tiny_params())[0][0]
                         .sigma_table)
    got = tuq.sample_sigma_tables(nominal, GSD, 5, seed=seed)
    np.testing.assert_array_equal(
        got, juq.sample_sigma_tables(nominal, GSD, 5, seed=seed))
    assert tuq.DEFAULT_GSD == juq.DEFAULT_GSD
    with pytest.raises(ValueError):
        tuq.sample_sigma_tables(nominal, {1: 0.5}, 2)


def _case_dict(c):
    return {k: np.asarray(getattr(c, k)) for k in
            ("coeff", "free", "dirichlet", "b_neumann", "grid_index",
             "sigma_table")}


@pytest.fixture(scope="module")
def ref():
    specs, params, meta = jarray.build_array_specs(_tiny_params())
    jcase, jhier = jla.assemble_lattice(specs[0], jnp.float64)
    loads = np.stack([s.b_neumann for s in specs])
    samples = juq.sample_sigma_tables(np.asarray(specs[0].sigma_table), GSD,
                                      3, seed=0)
    icase = interop.stencil_case_from_numpy(_case_dict(jcase), device="cpu")
    ihier = interop.hierarchy_from_numpy(
        [(np.asarray(lv.coeff), np.asarray(lv.free)) for lv in jhier.levels],
        specs[0].axes, device="cpu")
    return dict(jcase=jcase, jhier=jhier, loads=loads, samples=samples,
                icase=icase, ihier=ihier)


def _held(got, want):
    """phi within 1e-8 max|phi| (the reference test's own tolerance),
    every lane certified, iterations within 2 of the reference's; prints
    the measured delta (pytest -s)."""
    p = np.asarray(want.phi)
    assert bool(got.converged.all())
    assert float(got.residual.max()) <= TOL
    np.testing.assert_allclose(got.phi.numpy(), p, rtol=0,
                               atol=1e-8 * np.abs(p).max())
    np.testing.assert_array_less(
        np.abs(got.iterations.numpy() - np.asarray(want.iterations)), 3)
    rel = np.abs(got.phi.numpy() - p).max() / np.abs(p).max()
    print(f"phi within {rel:.2e} max|phi|; iterations "
          f"{got.iterations.tolist()}, reference "
          f"{np.asarray(want.iterations).tolist()}")


def test_batched_mg_solve_refined_matches_reference(ref):
    """A sweep of three sample tables, one load: the port's body-factored
    lane-stacked solve against the reference's vmapped combined ones."""
    tabs = ref["samples"]
    want = jmg.batched_mg_solve_refined(ref["jcase"], ref["jhier"],
                                        jnp.asarray(tabs), tol=TOL)
    got = tmg.batched_mg_solve_refined(ref["icase"], ref["ihier"],
                                       torch.as_tensor(tabs), tol=TOL)
    _held(got, want)


def test_ensemble_matches_reference(ref):
    """The (S, K) = (3, 4) lead-field ensemble: lanes s-major, phi (S, K,
    N), against the reference's vmap of vmaps."""
    tabs, loads = ref["samples"], ref["loads"]
    want = jlf.solve_basis_ensemble_refined(
        ref["jcase"], ref["jhier"], jnp.asarray(loads), jnp.asarray(tabs),
        tol=TOL)
    got = tlf.solve_basis_ensemble_refined(
        ref["icase"], ref["ihier"], torch.as_tensor(loads),
        torch.as_tensor(tabs), tol=TOL)
    assert tuple(got.phi.shape) == tuple(want.phi.shape)
    assert tuple(got.iterations.shape) == (3, 4)
    _held(got, want)


def test_per_lane_loads_chunked_as_one_call(ref):
    """A load per lane goes through the chunked solver with the tables:
    chunks of 3 (the last padded) give the lanes of one call."""
    tabs = torch.as_tensor(ref["samples"]).repeat_interleave(2, dim=0)[:5]
    loads = torch.as_tensor(ref["loads"])[[0, 1, 2, 3, 1]]
    sc = dataclasses.replace(ref["icase"], b_neumann=loads)
    one = tmg.batched_mg_solve_fused_refined(sc, ref["ihier"], tabs,
                                             tol=TOL)
    chunked = tmg.batched_mg_solve_fused_refined_chunked(
        sc, ref["ihier"], tabs, lanes_per_chunk=3, tol=TOL)
    np.testing.assert_array_equal(chunked.iterations.numpy(),
                                  one.iterations.numpy())
    np.testing.assert_allclose(chunked.phi.numpy(), one.phi.numpy(),
                               rtol=0, atol=1e-12 * one.phi.abs().max())
    # lane 4 (load 1 under table 2) is lane 1's load, not lane 1
    assert not torch.equal(one.phi[4], one.phi[1])
