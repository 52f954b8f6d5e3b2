"""ops/stencil_estimate of the port against the JAX package's on the CPU:
the grid-native ZZ indicators per cell against the JAX package's grid form
and against both packages' element path (the 6 Kuhn tets of a cell
summed), on the deformed, carved, 5-body ankle lattice with contact
volumes, and the goal weights, the dual spec and the axis weights."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pelvistim_fem_tpu.mesh.generate import layered_slab_recipe as jrecipe
from pelvistim_fem_tpu.mesh.spec import build_lattice_spec as jspec
from pelvistim_fem_tpu.models.ankle import (ankle_outline_pts as joutline,
                                            ankle_z_top as jztop)
from pelvistim_fem_tpu.models.case import build_case as jbuild
from pelvistim_fem_tpu.ops import estimate as jest
from pelvistim_fem_tpu.ops import stencil_estimate as jse
from pelvistim_fem_tpu_torch.mesh import core
from pelvistim_fem_tpu_torch.mesh.generate import layered_slab_recipe
from pelvistim_fem_tpu_torch.mesh.spec import build_lattice_spec
from pelvistim_fem_tpu_torch.models.ankle import (ankle_outline_pts,
                                                  ankle_z_top)
from pelvistim_fem_tpu_torch.models.case import build_case
from pelvistim_fem_tpu_torch.ops import estimate as pest
from pelvistim_fem_tpu_torch.ops import stencil_estimate as pse
from torch_threads import one_torch_thread  # noqa: E402,F401

SIG5 = {1: 0.35, 2: 0.04, 3: 1e-3, 4: 5e-3, 5: 5e-3}


def _ankle_recipe(make, outline, ztop):
    Lx, Ly, Lz = 0.08, 0.06, 0.04
    return make(
        Lx, Ly, Lz,
        layers=[(core.BODY_MUSCLE, 0.0335, 0.012),
                (core.BODY_FAT, 0.005, 0.005),
                (core.BODY_SKIN, 0.0015, 0.0015)],
        electrodes=[(0.015, 0.045, 0.01), (0.065, 0.045, 0.01)],
        contact_t=0.0005, contact_h_z=0.0005,
        h_fine=0.006, h_coarse=0.012,
        cross_section="ankle",
        ankle_z_top_fn=lambda x, y: ztop(x, y, Lx, Ly, Lz),
        outline_polygon=outline(Lx, Ly))


@pytest.fixture(scope="module")
def ankle():
    recipe = _ankle_recipe(layered_slab_recipe, ankle_outline_pts,
                           ankle_z_top)
    jr = _ankle_recipe(jrecipe, joutline, jztop)
    kw = dict(mode="current", injected_current_A=5e-3)
    spec, mesh = build_lattice_spec(recipe, SIG5, **kw), recipe.mesh()
    jmesh = jr.mesh()
    case = build_case(mesh, SIG5, device="cpu", **kw)
    jcase = jbuild(jmesh, SIG5, dtype=jnp.float64, to_device=False, **kw)
    nodes = np.asarray(mesh.nodes)
    x, y, z = nodes[:, 0], nodes[:, 1], nodes[:, 2]
    phi = np.sin(40 * x) * np.cosh(25 * z) + 30 * y * y * z
    psi = np.cos(30 * y) * z + 5 * x ** 2
    # kept tet r -> its lattice cell (lattice_tets is cell x-major,
    # class-minor, and carving keeps the order)
    keep = np.asarray(spec.body6).transpose(1, 2, 3, 0).reshape(-1) > 0
    cell_of_tet = np.repeat(np.arange(keep.size // 6), 6)[keep]
    cells = (len(recipe.xs) - 1, len(recipe.ys) - 1, len(recipe.zs) - 1)
    return dict(spec=spec, jspec=jspec(jr, SIG5, **kw), case=case,
                jcase=jcase, phi=phi, psi=psi, cell_of_tet=cell_of_tet,
                cells=cells)


def _per_cell(a, w):
    return np.bincount(a["cell_of_tet"], weights=w,
                       minlength=int(np.prod(a["cells"]))).reshape(
                           a["cells"])


@pytest.mark.parametrize("table", [None, "moved"])
def test_grid_zz_matches_both_element_paths_and_the_reference(ankle,
                                                              table):
    a = ankle
    tab = (None if table is None else
           np.asarray(a["spec"].sigma_table) * np.array(
               [1.0, 2.0, 0.5, 3.0, 1.0, 0.25]))
    jt = None if tab is None else jnp.asarray(tab)
    tt = None if tab is None else torch.as_tensor(tab)
    out = pse.lattice_zz_error(a["spec"], a["phi"], tab, device="cpu")
    ref = jse.lattice_zz_error(a["jspec"], a["phi"], tab)
    eta2 = out["eta2_cells"].numpy()
    np.testing.assert_allclose(eta2, np.asarray(ref["eta2_cells"]),
                               rtol=1e-12, atol=1e-14 * eta2.max())
    np.testing.assert_allclose(out["eta2_class"].numpy(),
                               np.asarray(ref["eta2_class"]), rtol=1e-12,
                               atol=1e-14 * eta2.max())
    for k in ("eta", "en2", "rel"):
        np.testing.assert_allclose(float(out[k]), float(ref[k]), rtol=1e-12)
    # the element path of each package, summed per cell
    for eta_e in (
            pest.zz_error_indicators(a["case"], torch.as_tensor(a["phi"]),
                                     tt).numpy(),
            np.asarray(jest.zz_error_indicators(a["jcase"],
                                                jnp.asarray(a["phi"]), jt))):
        want = _per_cell(a, eta_e ** 2)
        np.testing.assert_allclose(eta2, want, rtol=0,
                                   atol=1e-10 * want.max())
        np.testing.assert_allclose(float(out["eta"]),
                                   np.sqrt(want.sum()), rtol=1e-12)
    wx, wy, wz = pse.lattice_axis_weights_from_cells(out["eta2_cells"])
    for g, w in zip((wx, wy, wz),
                    jse.lattice_axis_weights_from_cells(ref["eta2_cells"])):
        np.testing.assert_allclose(g, w, rtol=1e-12)


def test_grid_goal_weights_match(ankle):
    a = ankle
    est = [pse.lattice_zz_error(a["spec"], f, device="cpu")
           for f in (a["phi"], a["psi"])]
    w = pse.lattice_goal_weights(*est).numpy()
    jw = np.asarray(jse.lattice_goal_weights(
        *[jse.lattice_zz_error(a["jspec"], f) for f in (a["phi"], a["psi"])]))
    np.testing.assert_allclose(w, jw, rtol=1e-12, atol=1e-14 * jw.max())
    w_e = pest.zz_goal_indicators(a["case"], torch.as_tensor(a["phi"]),
                                  torch.as_tensor(a["psi"])).numpy()
    want = _per_cell(a, w_e)
    np.testing.assert_allclose(w, want, rtol=0, atol=1e-10 * want.max())


def test_dual_spec_equals_reference(ankle):
    a = ankle
    q = np.linspace(-1.0, 1.0, len(a["spec"].grid_index))
    got = pse.lattice_dual_spec(a["spec"], q)
    want = jse.lattice_dual_spec(a["jspec"], q)
    for f in dataclasses.fields(got):
        g, w = getattr(got, f.name), getattr(want, f.name)
        if isinstance(g, np.ndarray):
            np.testing.assert_array_equal(g, w, err_msg=f.name)
    assert not got.dirichlet.any()


def test_grid_zz_vanishes_on_p1_exact_divider():
    """A two-layer slab with the series divider's piecewise-linear field:
    P1-exact, so the by-body grid estimator reports ~zero."""
    Lx, Ly, Lz = 0.04, 0.04, 0.04
    recipe = layered_slab_recipe(
        Lx, Ly, Lz,
        layers=[(core.BODY_MUSCLE, 0.02, 0.008),
                (core.BODY_FAT, 0.02, 0.008)],
        electrodes=[(0.02, 0.02, 0.012), (0.02, 0.02, 0.012)],
        contact_t=0.0, h_fine=0.008, h_coarse=0.008)
    spec = build_lattice_spec(recipe, {1: 1.0, 2: 10.0}, mode="voltage")
    z = np.asarray(recipe.mesh().nodes)[:, 2]
    J = 1.0 / (0.02 / 1.0 + 0.02 / 10.0)
    phi = np.where(z < 0.02, J * z, J * 0.02 + J * (z - 0.02) / 10.0)
    out = pse.lattice_zz_error(spec, phi, device="cpu")
    assert float(out["rel"]) < 1e-12 and float(out["eta"]) < 1e-12 * J
    with pytest.raises(ValueError, match="scalar sigma"):
        pse.lattice_zz_error(spec, phi, np.ones((3, 3, 3)), device="cpu")
