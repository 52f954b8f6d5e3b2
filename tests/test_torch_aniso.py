"""PyTorch port: anisotropic (tensor) conductivity tables against the JAX
package, all in f64 on the CPU: the tables of ops/aniso, the
tensor branch of the device assembly (lattice_coeff, pre-combined to one
stencil, differentiable in both modes) and the gradient through it
(ops/adjoint.solve_lattice_mg_diff), the element path's tensor forms
(assembly, the element solve, fields, injected_currents) and the
explicit shape dispatch between lane-stacked scalar tables and tensor
tables."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch.autograd.forward_ad as fwAD  # noqa: E402

from pelvistim_fem_tpu.mesh import core as jcore  # noqa: E402
from pelvistim_fem_tpu.models.pressure import \
    build_pressure_case as jax_pressure_case  # noqa: E402
from pelvistim_fem_tpu.models.pressure import \
    build_pressure_spec as jax_pressure_spec  # noqa: E402
from pelvistim_fem_tpu.ops import adjoint as jadj  # noqa: E402
from pelvistim_fem_tpu.ops import aniso as janiso  # noqa: E402
from pelvistim_fem_tpu.ops import assembly as jasm  # noqa: E402
from pelvistim_fem_tpu.ops import fields as jfields  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import metrics as jmetrics  # noqa: E402
from pelvistim_fem_tpu.ops import solve as jsolve  # noqa: E402

from pelvistim_fem_tpu_torch.mesh import core  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    build_pressure_case, build_pressure_spec)
from pelvistim_fem_tpu_torch.ops import adjoint  # noqa: E402
from pelvistim_fem_tpu_torch.ops import aniso  # noqa: E402
from pelvistim_fem_tpu_torch.ops import assembly  # noqa: E402
from pelvistim_fem_tpu_torch.ops import fields  # noqa: E402
from pelvistim_fem_tpu_torch.ops import lattice_assembly as tla  # noqa: E402
from pelvistim_fem_tpu_torch.ops import metrics  # noqa: E402
from pelvistim_fem_tpu_torch.ops import solve  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
# muscle fibers along y, fat along x (tests/test_aniso.py)
FIBERS = {core.BODY_MUSCLE: ((0, 1, 0), 0.4, 0.09),
          core.BODY_FAT: ((1, 0, 0), 0.06, 0.03)}


@pytest.fixture(scope="module")
def lattice():
    """The coarse step04 spec in both packages, f64 device arrays and the
    fiber table."""
    jspec, _ = jax_pressure_spec(coarse=True)
    spec, _ = build_pressure_spec(coarse=True)
    tab = aniso.tensor_table(spec.sigma_table, FIBERS)
    return dict(jdev=jla.spec_device_arrays(jspec, jnp.float64),
                dev=tla.spec_device_arrays(spec, F64, "cpu"), spec=spec,
                tab=tab)


@pytest.fixture(scope="module")
def element():
    """The coarse step04 element Case in both packages (f64), the fiber
    table, and the reference's certified tensor solve at tol 1e-10."""
    jcase, _ = jax_pressure_case(coarse=True, dtype=jnp.float64)
    case, _ = build_pressure_case(coarse=True, dtype=F64, device="cpu")
    tab = aniso.tensor_table(case.sigma_table.numpy(), FIBERS)
    ref = jsolve.solve_case_refined(jcase, jnp.asarray(tab), tol=1e-10)
    return dict(jcase=jcase, case=case, tab=tab, ref=ref)


def _coeff(d, n_bodies, tab):
    return tla.lattice_coeff(d["h_axes"], d["coords_dev"], d["body6"],
                             n_bodies, sigma_table=tab)


def test_tables_match_reference():
    sig = np.array([0.0, 0.35, 0.04, 1e-3, 5e-3, 5e-3])
    np.testing.assert_array_equal(
        aniso.tensor_table(sig, FIBERS),
        janiso.tensor_table(sig, {jcore.BODY_MUSCLE: ((0, 1, 0), 0.4, 0.09),
                                  jcore.BODY_FAT: ((1, 0, 0), 0.06, 0.03)}))
    np.testing.assert_array_equal(
        aniso.uniaxial_tensor((1, 0, 1), 0.4, 0.09),
        janiso.uniaxial_tensor((1, 0, 1), 0.4, 0.09))


def test_check_spd_guards_and_device():
    bad = np.zeros((2, 3, 3))
    bad[1] = [[1, 0.5, 0], [0.2, 1, 0], [0, 0, 1]]
    with pytest.raises(ValueError, match="symmetric"):
        aniso.check_spd(bad, device="cpu")
    neg = np.zeros((2, 3, 3))
    neg[1] = np.diag([1.0, -0.2, 1.0])
    with pytest.raises(ValueError, match="PSD"):
        aniso.check_spd(neg, device="cpu")
    with pytest.raises(ValueError, match="tensor table"):
        aniso.check_spd(np.ones(3), device="cpu")
    good = aniso.tensor_table(np.array([0.0, 0.2]),
                              {1: ((1, 1, 0), 0.4, 0.09)})
    t = aniso.check_spd(good, device="cpu")
    assert t.dtype == F64 and t.device.type == "cpu"
    np.testing.assert_array_equal(t.numpy(), good)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            aniso.check_spd(good)


def test_lattice_coeff_tensor_matches_reference(lattice):
    """The tensor branch, pre-combined to B = 1: within 1e-12 of max|C|."""
    n = lattice["spec"].n_bodies
    tab = lattice["tab"]
    ref = np.asarray(jla.lattice_coeff(
        lattice["jdev"]["h_axes"], lattice["jdev"]["coords_dev"],
        lattice["jdev"]["body6"], n, sigma_table=jnp.asarray(tab)))
    got = _coeff(lattice["dev"], n, torch.as_tensor(tab)).numpy()
    assert got.shape == (1, 27, 25, 14, 13)
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())


def test_lattice_coeff_isotropic_tensor_equals_scalar(lattice):
    spec = lattice["spec"]
    sig = torch.as_tensor(spec.sigma_table, dtype=F64)
    scalar = _coeff(lattice["dev"], spec.n_bodies, sig)
    tensor = _coeff(lattice["dev"], spec.n_bodies, torch.as_tensor(
        aniso.tensor_table(spec.sigma_table)))
    np.testing.assert_allclose(tensor.numpy(), scalar.numpy(), rtol=0,
                               atol=1e-13 * float(scalar.abs().max()))


def test_lattice_coeff_tensor_differentiable_both_modes(lattice):
    """d C / d Sigma_muscle[1, 2] along a symmetric direction: forward
    mode (the gather from the table keeps its tangent), reverse mode and
    central differences agree."""
    n = lattice["spec"].n_bodies
    tab = torch.as_tensor(lattice["tab"])
    b = core.BODY_MUSCLE
    tan = torch.zeros_like(tab)
    tan[b, 1, 2] = tan[b, 2, 1] = 1.0
    w = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (1, 27, 25, 14, 13)))
    with fwAD.dual_level():
        C = _coeff(lattice["dev"], n, fwAD.make_dual(tab, tan))
        jv = float(torch.sum(fwAD.unpack_dual(C).tangent * w))
    t = tab.clone().requires_grad_(True)
    g, = torch.autograd.grad(torch.sum(_coeff(lattice["dev"], n, t) * w), t)
    rev = float(torch.sum(g * tan))
    eps = 1e-6
    fd = float(torch.sum((_coeff(lattice["dev"], n, tab + eps * tan)
                          - _coeff(lattice["dev"], n, tab - eps * tan))
                         * w)) / (2 * eps)
    assert jv != 0.0
    assert abs(jv - rev) <= 1e-12 * abs(rev)
    assert abs(jv - fd) <= 1e-7 * abs(fd)


def test_tensor_grad_matches_reference_and_fd(lattice):
    """Gradients through the device assembly: d mean(phi^2) / d Sigma of
    the muscle's (1, 1), (2, 2) and (1, 2) components by
    solve_lattice_mg_diff: the reference's within rtol 1e-6, central
    differences (an off-diagonal move takes both symmetric slots) within
    3e-4."""
    spec, dev, jdev = lattice["spec"], lattice["dev"], lattice["jdev"]
    _, h = tla.assemble_lattice(spec, F64, device_arrays=dev)
    _, jh = jla.assemble_lattice(jax_pressure_spec(coarse=True)[0],
                                 jnp.float64, device_arrays=jdev)
    nb = spec.n_bodies
    base = aniso.tensor_table(spec.sigma_table,
                              {core.BODY_MUSCLE: ((0, 1, 0), 0.4, 0.09)})

    def J(tab):
        phi = adjoint.solve_lattice_mg_diff(dev, h, tab, n_bodies=nb,
                                            tol=1e-12)
        return torch.mean(phi * phi)

    t = torch.tensor(base, requires_grad=True)
    g, = torch.autograd.grad(J(t), t)
    gr = np.asarray(jax.grad(lambda tab: jnp.mean(
        jadj.solve_lattice_mg_diff(jdev, jh, tab, n_bodies=nb,
                                   tol=1e-12) ** 2))(jnp.asarray(base)))
    b = core.BODY_MUSCLE
    for (c, d) in [(1, 1), (2, 2), (1, 2)]:
        np.testing.assert_allclose(float(g[b, c, d]), gr[b, c, d],
                                   rtol=1e-6)
        eps = 1e-5 * (base[b, c, d] if base[b, c, d] != 0 else 0.1)
        mv = np.zeros_like(base)
        mv[b, c, d] = mv[b, d, c] = eps
        with torch.no_grad():
            fd = (float(J(torch.as_tensor(base + mv)))
                  - float(J(torch.as_tensor(base - mv)))) / (2 * eps)
        ga = float(g[b, c, d] + (g[b, d, c] if c != d else 0.0))
        assert fd != 0.0
        assert abs(ga - fd) <= 3e-4 * abs(fd), ((c, d), ga, fd)


def test_lattice_refined_tensor_solve_matches_element_path(lattice, element):
    """solve_lattice_mg_refined takes a tensor table: certified, and equal
    to the reference's element-path tensor solve on the same geometry
    (tests/test_aniso.py's bound)."""
    r = tla.solve_lattice_mg_refined(lattice["spec"],
                                     torch.as_tensor(lattice["tab"]),
                                     tol=1e-10, device="cpu")
    assert bool(r.converged) and float(r.residual) <= 1e-10
    ref = np.asarray(element["ref"].phi)
    np.testing.assert_allclose(r.phi.numpy(), ref, rtol=0,
                               atol=1e-7 * np.abs(ref).max())


def test_element_tensor_solve_matches_reference(element):
    """solve_case_refined with fibers in muscle and fat: phi within
    1e-10 max|phi| of the reference's; injected_currents as the
    reference's, flux_err_consistent below 1e-6."""
    case, tab = element["case"], torch.as_tensor(element["tab"])
    res = solve.solve_case_refined(case, tab, tol=1e-10)
    assert bool(res.converged) and float(res.residual) <= 1e-10
    ref = np.asarray(element["ref"].phi)
    np.testing.assert_allclose(res.phi.numpy(), ref, rtol=0,
                               atol=1e-10 * np.abs(ref).max())
    cur = metrics.injected_currents(case, res.phi, tab)
    jcur = jmetrics.injected_currents(element["jcase"], element["ref"].phi,
                                      sigma_table=jnp.asarray(element["tab"]))
    assert cur["flux_err_consistent"] < 1e-6
    for k in ("I_active", "I_return", "I_active_consistent",
              "I_return_consistent"):
        np.testing.assert_allclose(cur[k], jcur[k], rtol=1e-9)


def test_element_tensor_operator_matches_reference(element):
    """The tensor apply and Jacobi diagonal (assembly.spmv,
    stiffness_diagonal) on the same phi and table."""
    jc, case = element["jcase"], element["case"]
    tab = element["tab"]
    sig_e = torch.as_tensor(tab)[case.tet_body]
    sigvol = sig_e * case.vol[:, None, None]
    phi = torch.tensor(np.asarray(element["ref"].phi))
    got = assembly.spmv(phi, case.tets, case.grads, sigvol,
                        case.scatter_table, tensor=True).numpy()
    jsv = jnp.asarray(tab)[jc.tet_body] * jc.vol[:, None, None]
    n = jc.nodes.shape[0]
    ref = np.asarray(jasm.spmv(element["ref"].phi, jc.tets, jc.grads, jsv,
                               jc.scatter_perm, jc.scatter_segids, n))
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=1e-12 * np.abs(ref).max())
    dg = assembly.stiffness_diagonal(case.grads, sigvol, case.scatter_table,
                                     tensor=True).numpy()
    dref = np.asarray(jasm.stiffness_diagonal(
        jc.tets, jc.grads, jsv, jc.scatter_perm, jc.scatter_segids, n))
    np.testing.assert_allclose(dg, dref, rtol=1e-12)


@pytest.mark.parametrize("lanes", [False, True])
def test_fields_tensor_forms_match_reference(element, lanes):
    """cell_J, cell_power_density, boundary_face_flux and
    consistent_electrode_currents with a (T, 3, 3) table, and with two
    lanes, phi (2, N) and tables (2, T, 3, 3), each lane the reference's
    function of its own table."""
    jc, case = element["jcase"], element["case"]
    tabs = [element["tab"], aniso.tensor_table(
        case.sigma_table.numpy(), {core.BODY_MUSCLE: ((1, 0, 1), 0.5, 0.1)})]
    phi = np.asarray(element["ref"].phi)
    phis = [phi, 0.5 * phi]
    if lanes:
        p, t = torch.as_tensor(np.stack(phis)), torch.as_tensor(
            np.stack(tabs))
    else:
        p, t = torch.as_tensor(phi), torch.as_tensor(tabs[0])
    got = dict(J=fields.cell_J(case, p, t).numpy(),
               pw=fields.cell_power_density(case, p, t).numpy(),
               flux=fields.boundary_face_flux(case, p, t).numpy(),
               cur=np.stack(fields.consistent_electrode_currents(
                   case, p, t), -1))
    for lane in range(2 if lanes else 1):
        jp, jt = jnp.asarray(phis[lane]), jnp.asarray(tabs[lane])
        ref = dict(J=jfields.cell_J(jc, jp, jt),
                   pw=jfields.cell_power_density(jc, jp, jt),
                   flux=jfields.boundary_face_flux(jc, jp, jt),
                   cur=np.stack(jfields.consistent_electrode_currents(
                       jc, jp, jt)))
        for k, v in ref.items():
            v = np.asarray(v)
            g = got[k][lane] if lanes else got[k]
            np.testing.assert_allclose(g, v, rtol=0,
                                       atol=1e-12 * np.abs(v).max(),
                                       err_msg=k)


def test_sigma_table_shape_dispatch(element):
    """A table is read by its shape against the case's T slots: (T,) and
    (L, T) scalars, (T, 3, 3) and (L, T, 3, 3) tensors; anything else,
    or a shape that could be both, raises.  A lane-stacked scalar table
    of three lanes, (3, T), stays scalar."""
    case = element["case"]
    T = case.sigma_table.shape[0]
    assert not assembly.is_tensor_table(torch.zeros(T), T)
    assert not assembly.is_tensor_table(torch.zeros(3, T), T)
    assert assembly.is_tensor_table(torch.zeros(T, 3, 3), T)
    assert assembly.is_tensor_table(torch.zeros(2, T, 3, 3), T)
    for bad in [(T + 1,), (T, 3), (T, 2, 2)]:
        with pytest.raises(ValueError, match="slots"):
            assembly.is_tensor_table(torch.zeros(bad), T)
    with pytest.raises(ValueError, match="both"):
        assembly.is_tensor_table(torch.zeros(3, 3, 3), 3)
    phi = torch.tensor(np.asarray(element["ref"].phi))
    sig = case.sigma_table
    iso = torch.as_tensor(aniso.tensor_table(sig.numpy()))
    J_s = fields.cell_J(case, phi[None].expand(3, -1),
                        sig[None].expand(3, -1))
    J_t = fields.cell_J(case, phi, iso)
    assert J_s.shape == (3, case.n_tets, 3) and J_t.shape == (case.n_tets, 3)
    np.testing.assert_allclose(J_s[1].numpy(), J_t.numpy(), rtol=1e-14,
                               atol=1e-14 * float(J_t.abs().max()))
