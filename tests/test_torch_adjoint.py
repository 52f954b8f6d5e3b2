"""PyTorch port: the differentiable solves (ops/adjoint) against the JAX
package's, in f64 on the CPU, and against their own central finite
differences: phi of solve_stencil_mg_diff, sigma_sensitivity of
mean(phi^2) in current mode (coarse step04) and voltage mode (the
two-electrode slab of tests/test_adjoint.py), forward mode against
reverse mode and the Dirichlet and Neumann cotangents (the tensor
gradient of solve_lattice_mg_diff is in tests/test_torch_aniso.py).  The
JAX package is imported by the
fixtures, so the test marked `cuda` (the Function's cotangents on a card)
runs without it:

    python -m pytest --noconftest -m cuda tests/test_torch_adjoint.py -q
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.autograd.forward_ad as fwAD  # noqa: E402

from pelvistim_fem_tpu_torch.mesh import core  # noqa: E402
from pelvistim_fem_tpu_torch.mesh.generate import (  # noqa: E402
    box_recipe, layered_slab_recipe)
from pelvistim_fem_tpu_torch.mesh.spec import \
    build_lattice_spec  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import \
    build_pressure_spec  # noqa: E402
from pelvistim_fem_tpu_torch.ops import adjoint  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from pelvistim_fem_tpu_torch.ops.multigrid import \
    solve_stencil_mg  # noqa: E402
from pelvistim_fem_tpu_torch.ops.stencil import combine_coeffs  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F64 = torch.float64
# the voltage-mode slab of tests/test_adjoint.py:54-71
SLAB = dict(layers=[(core.BODY_MUSCLE, 0.017, 0.009),
                    (core.BODY_FAT, 0.002, 0.002),
                    (core.BODY_SKIN, 0.001, 0.001)],
            electrodes=[(0.008, 0.022, 0.005), (0.032, 0.022, 0.005)],
            contact_t=0.0005, contact_h_z=0.0005, h_fine=0.004,
            h_coarse=0.008)
SIG5 = {1: 0.35, 2: 0.04, 3: 1e-3, 4: 5e-3, 5: 5e-3}


def _metric(phi, sig):
    return torch.mean(phi * phi)


@pytest.fixture(scope="module")
def jx():
    """The JAX package's modules, x64 on the CPU (tests/conftest.py)."""
    import jax
    import jax.numpy as jnp

    from pelvistim_fem_tpu.mesh.generate import layered_slab_recipe as jslab
    from pelvistim_fem_tpu.mesh.spec import build_lattice_spec as jbuild
    from pelvistim_fem_tpu.models.pressure import build_pressure_spec as jps
    from pelvistim_fem_tpu.ops import adjoint as jadj
    from pelvistim_fem_tpu.ops import lattice_assembly as jla
    return dict(jax=jax, jnp=jnp, slab=jslab, build=jbuild, spec=jps,
                adj=jadj, la=jla)


@pytest.fixture(scope="module")
def coarse(jx):
    """The coarse step04 lattice (25, 14, 13), current mode, assembled in
    f64 by both packages."""
    jspec, _ = jx["spec"](coarse=True)
    spec, _ = build_pressure_spec(coarse=True)
    jc, jh = jx["la"].assemble_lattice(jspec, jx["jnp"].float64)
    sc, h = assemble_lattice(spec, F64, device="cpu")
    return dict(spec=spec, jspec=jspec, jc=jc, jh=jh, sc=sc, h=h)


def _fd_check(sc, h, sig, slots, rel=2e-4):
    """The port's gradient against its own central differences."""
    J, g = adjoint.sigma_sensitivity(_metric, sc, h, sig, tol=1e-12)
    for b in slots:
        eps = 1e-4 * float(sig[b])
        up, dn = sig.clone(), sig.clone()
        up[b] += eps
        dn[b] -= eps
        with torch.no_grad():
            fd = (float(_metric(adjoint.solve_stencil_mg_diff(
                sc, h, up, tol=1e-12), up)) - float(_metric(
                    adjoint.solve_stencil_mg_diff(sc, h, dn, tol=1e-12),
                    dn))) / (2 * eps)
        assert fd != 0.0
        assert abs(float(g[b]) - fd) <= rel * abs(fd), (b, float(g[b]), fd)
    return J, g


def _jax_grad(jx, jc, jh, sig):
    jnp = jx["jnp"]
    return jx["adj"].sigma_sensitivity(lambda p, s: jnp.mean(p * p), jc, jh,
                                       jnp.asarray(sig), tol=1e-12)


def test_solution_matches_reference_and_nondiff_solver(coarse, jx):
    sig = coarse["spec"].sigma_table
    ref = np.asarray(jx["adj"].solve_stencil_mg_diff(
        coarse["jc"], coarse["jh"], jx["jnp"].asarray(sig), tol=1e-11))
    stats = []
    phi = adjoint.solve_stencil_mg_diff(coarse["sc"], coarse["h"],
                                        torch.as_tensor(sig), tol=1e-11,
                                        stats=stats)
    np.testing.assert_allclose(phi.numpy(), ref, rtol=0,
                               atol=1e-9 * np.abs(ref).max())
    nd = solve_stencil_mg(coarse["sc"], coarse["h"], tol=1e-11)
    np.testing.assert_allclose(phi.numpy(), nd.phi.numpy(), rtol=0,
                               atol=1e-9 * np.abs(ref).max())
    assert stats == [("forward", int(nd.iterations))]


def test_grad_current_mode_matches_reference_and_fd(coarse, jx):
    """Slots 1, 3, 4 (muscle, skin, the active contact): the reference's
    jax.value_and_grad within rtol 1e-6, central differences within
    2e-4; slot 0 (carved) never enters."""
    sig = torch.as_tensor(coarse["spec"].sigma_table, dtype=F64)
    J, g = _fd_check(coarse["sc"], coarse["h"], sig, [1, 3, 4])
    Jr, gr = _jax_grad(jx, coarse["jc"], coarse["jh"], sig.numpy())
    assert float(J) > 0
    np.testing.assert_allclose(float(J), float(Jr), rtol=1e-9)
    np.testing.assert_allclose(g.numpy()[[1, 3, 4]],
                               np.asarray(gr)[[1, 3, 4]], rtol=1e-6)
    assert float(g[0]) == 0.0


def test_grad_voltage_mode_matches_reference_and_fd(jx):
    """Voltage drive: sigma enters through K and through the Dirichlet
    lift; a uniform scaling of sigma leaves phi as it is, so g . sigma
    vanishes (to 1e-6 of the largest term, as the reference checks)."""
    spec = build_lattice_spec(layered_slab_recipe(0.04, 0.03, 0.02, **SLAB),
                              SIG5, mode="voltage", active_V=1.0)
    sc, h = assemble_lattice(spec, F64, device="cpu")
    sig = torch.as_tensor(spec.sigma_table, dtype=F64)
    _, g = _fd_check(sc, h, sig, [1, 4])
    jnp = jx["jnp"]
    jspec = jx["build"](jx["slab"](0.04, 0.03, 0.02, **SLAB), SIG5,
                        mode="voltage", active_V=1.0)
    jc, jh = jx["la"].assemble_lattice(jspec, jnp.float64)
    _, gr = _jax_grad(jx, jc, jh, sig.numpy())
    np.testing.assert_allclose(g.numpy()[[1, 4]], np.asarray(gr)[[1, 4]],
                               rtol=1e-6)
    gs = g.numpy() * sig.numpy()
    assert abs(gs.sum()) <= 1e-6 * np.abs(gs).max()


def test_forward_mode_matches_reverse(coarse):
    """MaskedStencilSolve's jvp (one tangent solve) along a direction v
    equals the adjoint gradient's g . v."""
    sc, h = coarse["sc"], coarse["h"]
    sig = torch.as_tensor(coarse["spec"].sigma_table, dtype=F64)
    v = torch.as_tensor(np.random.default_rng(1).standard_normal(6)) * sig
    _, g = adjoint.sigma_sensitivity(_metric, sc, h, sig, tol=1e-12)
    stats = []
    with fwAD.dual_level():
        phi = adjoint.solve_stencil_mg_diff(sc, h, fwAD.make_dual(sig, v),
                                            tol=1e-12, stats=stats)
        p, t = fwAD.unpack_dual(phi)
        jv = float(torch.mean(2 * p * t))
    assert [k for k, _ in stats] == ["forward", "tangent"]
    assert abs(jv - float(torch.sum(g * v))) <= 1e-8 * abs(jv)


@pytest.mark.parametrize("which", ["dirichlet", "b_neumann"])
def test_grad_of_drive_scale(which):
    """d mean(phi^2) / ds at s = 1 for phi of the drive scaled by s (the
    active voltage of a voltage-driven box, or the load of the current-
    driven coarse step04 case): phi scales linearly, so it is 2 mean(phi^2)
    in reverse and forward mode (the d and b_n cotangents and tangents)."""
    if which == "dirichlet":
        spec = build_lattice_spec(box_recipe(0.04, 0.04, 0.02, 0.004),
                                  {1: 0.2}, mode="voltage", active_V=1.0)
    else:
        spec, _ = build_pressure_spec(coarse=True)
    sc, h = assemble_lattice(spec, F64, device="cpu")

    def J(s):
        scs = dataclasses.replace(sc, **{which: getattr(sc, which) * s})
        phi = adjoint.solve_stencil_mg_diff(scs, h, tol=1e-12)
        return torch.mean(phi * phi)

    s = torch.tensor(1.0, dtype=F64, requires_grad=True)
    val = J(s)
    g, = torch.autograd.grad(val, s)
    assert abs(float(g) - 2 * float(val)) <= 1e-6 * abs(float(g))
    with fwAD.dual_level():
        Jd = J(fwAD.make_dual(torch.tensor(1.0, dtype=F64),
                              torch.tensor(1.0, dtype=F64)))
        jv = float(fwAD.unpack_dual(Jd).tangent)
    assert abs(jv - 2 * float(val)) <= 1e-6 * abs(jv)


def test_plane_products_is_the_stencil_cotangent():
    """plane_products(lam, x) is the cotangent of C in stencil_spmv(x, C)
    for a cotangent lam of its output (autograd of the plain twin)."""
    rng = np.random.default_rng(2)
    x = torch.as_tensor(rng.standard_normal((5, 4, 6)))
    lam = torch.as_tensor(rng.standard_normal((5, 4, 6)))
    C = torch.as_tensor(rng.standard_normal((27, 5, 4, 6)),
                        ).requires_grad_(True)
    g, = torch.autograd.grad(sk.stencil_spmv_plain(x, C), C, lam)
    np.testing.assert_allclose(adjoint.plane_products(lam, x).numpy(),
                               g.numpy(), rtol=1e-15, atol=1e-15)


@pytest.mark.cuda
def test_cotangents_on_the_card():
    """On a CUDA card the Function's backward (the adjoint MG-PCG, kernel
    1 for d's cotangent) gives C, d and b_n cotangents that are there,
    finite, not zero, and equal to the CPU's within 1e-8 of their
    largest; and its jvp the CPU's tangent."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    spec, _ = build_pressure_spec(coarse=True)
    out = {}
    for dev in ("cpu", "cuda"):
        sc, h = assemble_lattice(spec, F64, device=dev)
        solver = adjoint.MGSolver(h, sc.sigma_table, sc.free, tol=1e-12,
                                  maxiter=2_000)
        C = combine_coeffs(sc.coeff, sc.sigma_table).requires_grad_(True)
        d = sc.dirichlet.clone().requires_grad_(True)
        b = sc.b_neumann.clone().requires_grad_(True)
        sk.reset_launches()
        x = adjoint.MaskedStencilSolve.apply(C, d, b, solver, None)
        grads = torch.autograd.grad(torch.mean(x * x), (C, d, b))
        launches = dict(sk.LAUNCHES)
        with fwAD.dual_level():
            xd = adjoint.MaskedStencilSolve.apply(
                fwAD.make_dual(C.detach(), C.detach().clone()), d.detach(),
                b.detach(),
                solver, None)
            tangent = fwAD.unpack_dual(xd).tangent
        out[dev] = [a.cpu() for a in grads + (tangent,)], launches
    for name, got, want in zip(("C", "d", "b_n", "jvp"), out["cuda"][0],
                               out["cpu"][0]):
        assert got is not None and bool(got.isfinite().all()), name
        assert float(got.abs().max()) > 0, name
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                                   atol=1e-8 * float(want.abs().max()),
                                   err_msg=name)
    launches = out["cuda"][1]
    assert launches["stencil_spmv_cuda"] >= 2       # b_eff's lift, d_bar
    assert launches["level_apply_cuda"] > 0
