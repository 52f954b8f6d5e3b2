"""mesh/refine of the port against the JAX package's on the CPU: the
bisection mesh, its refinement and the mesh it materialises are equal bit
for bit on the same marks, and Doerfler marking picks the same tets from
the same indicators."""

import numpy as np
import pytest

from pelvistim_fem_tpu.mesh import generate as jgen
from pelvistim_fem_tpu.mesh import refine as jref
from pelvistim_fem_tpu.models.ankle import layered_model_inputs as jinputs
from pelvistim_fem_tpu.models.case import build_case as jbuild
from pelvistim_fem_tpu.ops.estimate import zz_error_indicators
from pelvistim_fem_tpu.ops.solve import solve_case as jsolve
from pelvistim_fem_tpu_torch.mesh import generate
from pelvistim_fem_tpu_torch.mesh import refine
from pelvistim_fem_tpu_torch.models.ankle import layered_model_inputs
from torch_threads import one_torch_thread  # noqa: E402,F401

L = 0.01


def _assert_bm_equal(got, want):
    for f in ("nodes", "tets", "levels", "tet_body", "edge_keys",
              "edge_mids"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)


def _assert_mesh_equal(got, want):
    for f in ("nodes", "tets", "tet_body", "faces", "face_bcid",
              "face_parent"):
        g, w = getattr(got, f), getattr(want, f)
        assert g.dtype == w.dtype, f
        np.testing.assert_array_equal(g, w, err_msg=f)
    assert got.lattice is None and want.lattice is None


def test_random_rounds_on_a_box_bit_identical():
    bm = refine.BisectionMesh.from_recipe(generate.box_recipe(L, L, L,
                                                              L / 4))
    jbm = jref.BisectionMesh.from_recipe(jgen.box_recipe(L, L, L, L / 4))
    _assert_bm_equal(bm, jbm)
    rng = np.random.default_rng(0)
    for r in range(4):
        marks = rng.random(bm.n_tets) < 0.15
        bm, jbm = bm.refine(marks), jbm.refine(marks)
        _assert_bm_equal(bm, jbm)
    _assert_mesh_equal(bm.mesh(), jbm.mesh())


@pytest.fixture(scope="module")
def layered():
    """The coarse step03 anchor as a bisection mesh in both packages and
    the reference's indicators on its solve."""
    (Lx, Ly, Lz), rk, sig, bc, meta, _ = layered_model_inputs(coarse=True)
    (jLx, jLy, jLz), jrk, jsig, jbc, jmeta, _ = jinputs(coarse=True)
    bm = refine.BisectionMesh.from_recipe(
        generate.layered_slab_recipe(Lx, Ly, Lz, **rk))
    jbm = jref.BisectionMesh.from_recipe(
        jgen.layered_slab_recipe(jLx, jLy, jLz, **jrk))
    jcase = jbuild(jbm.mesh(), jsig, meta_extra=jmeta, **jbc)
    phi = jsolve(jcase, tol=1e-10, maxiter=30_000).phi
    eta = np.asarray(zz_error_indicators(jcase, phi))
    return bm, jbm, eta


@pytest.mark.parametrize("theta", [0.5, 0.3])
def test_doerfler_refinement_of_the_anchor_bit_identical(layered, theta):
    """Two rounds of Doerfler marking on the reference's indicators (the
    second round's indicators: the first round's, inherited by the
    children) through both packages' marking and refinement."""
    bm, jbm, eta = layered
    _assert_bm_equal(bm, jbm)
    _assert_mesh_equal(bm.mesh(), jbm.mesh())
    for _ in range(2):
        marks = refine.mark_doerfler(eta, theta=theta)
        np.testing.assert_array_equal(marks,
                                      jref.mark_doerfler(eta, theta=theta))
        n0 = bm.n_tets
        bm, jbm = bm.refine(marks), jbm.refine(marks)
        _assert_bm_equal(bm, jbm)
        # children inherit their parent's indicator
        eta = np.concatenate([eta, np.zeros(bm.n_tets - n0)])
    m = bm.mesh()
    _assert_mesh_equal(m, jbm.mesh())
    m.validate()


def test_mark_doerfler_with_ties_matches():
    eta = np.repeat([3.0, 1.0, 2.0, 2.0, 0.0], 7)
    for theta in (0.1, 0.5, 0.9, 1.0):
        np.testing.assert_array_equal(refine.mark_doerfler(eta, theta),
                                      jref.mark_doerfler(eta, theta))


def test_refined_mesh_keeps_the_recipes_classification():
    """A deformed recipe (the ankle cross-section) is refined on the
    undeformed lattice and deformed last, as the reference does."""
    from pelvistim_fem_tpu.models.ankle import (ankle_outline_pts as jo,
                                                ankle_z_top as jz)
    from pelvistim_fem_tpu_torch.mesh import core
    from pelvistim_fem_tpu_torch.models.ankle import (ankle_outline_pts,
                                                      ankle_z_top)
    kw = dict(layers=[(core.BODY_MUSCLE, 0.0335, 0.012),
                      (core.BODY_FAT, 0.005, 0.005),
                      (core.BODY_SKIN, 0.0015, 0.0015)],
              electrodes=[(0.015, 0.045, 0.01), (0.065, 0.045, 0.01)],
              contact_t=0.0005, contact_h_z=0.0005, h_fine=0.006,
              h_coarse=0.012, cross_section="ankle")
    r = generate.layered_slab_recipe(
        0.08, 0.06, 0.04, **kw,
        ankle_z_top_fn=lambda x, y: ankle_z_top(x, y, 0.08, 0.06, 0.04),
        outline_polygon=ankle_outline_pts(0.08, 0.06))
    jr = jgen.layered_slab_recipe(
        0.08, 0.06, 0.04, **kw,
        ankle_z_top_fn=lambda x, y: jz(x, y, 0.08, 0.06, 0.04),
        outline_polygon=jo(0.08, 0.06))
    bm = refine.BisectionMesh.from_recipe(r)
    jbm = jref.BisectionMesh.from_recipe(jr)
    marks = np.zeros(bm.n_tets, bool)
    marks[::7] = True
    bm, jbm = bm.refine(marks), jbm.refine(marks)
    _assert_bm_equal(bm, jbm)
    _assert_mesh_equal(bm.mesh(), jbm.mesh())
