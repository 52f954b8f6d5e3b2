"""PyTorch port: the Jacobi stencil solvers and the stencil kernels' twins
that stand for TPU kernels 3-5, against the JAX package.

The twins are held against the Pallas kernels in interpret mode, as
tests/test_pallas.py runs them, at that file's shapes (f32), and against
the XLA formulations in f64.  The solvers run on the JAX-built coarse
step04 StencilCase, handed over as numpy arrays through interop."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import pelvistim_fem_tpu.ops.pallas_stencil as ps  # noqa: E402
from pelvistim_fem_tpu.models.pressure import (  # noqa: E402
    build_pressure_case as jax_pressure_case, sigma_tables_for_sweep)
from pelvistim_fem_tpu.ops import solve as jsolve  # noqa: E402
from pelvistim_fem_tpu.ops import stencil as jst  # noqa: E402

from pelvistim_fem_tpu_torch import interop  # noqa: E402
from pelvistim_fem_tpu_torch.ops import solve as tsolve  # noqa: E402
from pelvistim_fem_tpu_torch.ops import stencil as tst  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=2e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=0)
TOL = 1e-8
# four of the reference's 15 contact levels: both ends and two between
LANES = [0, 4, 9, 14]


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    if jax.devices()[0].platform == "cpu":
        orig = pl.pallas_call

        def interp(*a, **k):
            k["interpret"] = True
            return orig(*a, **k)

        monkeypatch.setattr(ps.pl, "pallas_call", interp)
    yield


def _rand(rng, shape, dtype):
    a = rng.standard_normal(shape)
    return torch.as_tensor(a, dtype=dtype), jnp.asarray(a, dtype=str(
        dtype).split(".")[-1])


# ── kernel twins against the Pallas kernels ───────────────────────────


@pytest.mark.parametrize("L,B,shape", [(3, 5, (8, 7, 6)),
                                       (5, 2, (14, 9, 8))])
def test_kernel4_lminor_twin_matches_pallas(L, B, shape):
    """batched_stencil_spmv_lminor_plain vs the Pallas
    batched_stencil_spmv_fused_lminor (kernel 4), f32."""
    rng = np.random.default_rng(1)
    X_t, X_j = _rand(rng, shape + (L,), torch.float32)
    c_t, c_j = _rand(rng, (B, 27) + shape, torch.float32)
    sig = rng.random((B, L))
    ref = np.asarray(ps.batched_stencil_spmv_fused_lminor(
        X_j, c_j, jnp.asarray(sig, jnp.float32)))
    y = sk.batched_stencil_spmv_lminor(
        X_t, c_t, torch.as_tensor(sig, dtype=torch.float32))
    assert y.shape == X_t.shape and y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, **F32)


@pytest.mark.parametrize("L,B,shape", [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)),
                                       (2, 1, (6, 5, 4))])
def test_kernel4_lminor_twin_matches_xla_f64(L, B, shape):
    """The lane-minor twin in f64 vs the reference's lane-major XLA
    formulation, transposed: one function in two layouts."""
    rng = np.random.default_rng(2)
    X_t, X_j = _rand(rng, (L,) + shape, torch.float64)
    c_t, c_j = _rand(rng, (B, 27) + shape, torch.float64)
    tab = rng.random((L, B + 1))
    ref = np.asarray(jst.batched_stencil_spmv_fused(X_j, c_j,
                                                    jnp.asarray(tab)))
    sig = torch.as_tensor(tab[:, 1:].T.copy())
    y = sk.batched_stencil_spmv_lminor_plain(
        X_t.permute(1, 2, 3, 0).contiguous(), c_t, sig)
    np.testing.assert_allclose(y.permute(3, 0, 1, 2).numpy(), ref, **F64)


@pytest.mark.parametrize("shape", [(8, 7, 6), (20, 13, 9), (31, 16, 8)])
def test_kernel3_stencil_spmv_twin_matches_pallas(shape):
    """stencil_spmv_plain (the twin of stencil_spmv_cuda, the counterpart
    of kernel 3) vs the Pallas stencil_spmv_pallas, f32."""
    rng = np.random.default_rng(0)
    x_t, x_j = _rand(rng, shape, torch.float32)
    C_t, C_j = _rand(rng, (27,) + shape, torch.float32)
    ref = np.asarray(ps.stencil_spmv_pallas(x_j, C_j))
    np.testing.assert_allclose(sk.stencil_spmv_plain(x_t, C_t).numpy(), ref,
                               **F32)


@pytest.mark.parametrize("L,B,shape", [(3, 5, (8, 7, 6)),
                                       (5, 2, (14, 9, 8))])
def test_kernel5_batched_fused_matches_pallas(L, B, shape):
    """stencil.batched_stencil_spmv_fused (batched_stencil_spmv_cuda on
    the card, the counterpart of kernel 5) vs the Pallas
    batched_stencil_spmv_fused_pallas, f32, on the same tables."""
    rng = np.random.default_rng(1)
    X_t, X_j = _rand(rng, (L,) + shape, torch.float32)
    c_t, c_j = _rand(rng, (B, 27) + shape, torch.float32)
    tab = rng.random((L, B + 1))
    ref = np.asarray(ps.batched_stencil_spmv_fused_pallas(
        X_j, c_j, jnp.asarray(tab, jnp.float32)))
    y = tst.batched_stencil_spmv_fused(
        X_t, c_t, torch.as_tensor(tab, dtype=torch.float32))
    np.testing.assert_allclose(y.numpy(), ref, **F32)


def test_lminor_dispatch_on_cpu_takes_the_twin():
    sk.reset_launches()
    Xm = torch.ones((4, 3, 3, 2))
    coeff = torch.ones((1, 27, 4, 3, 3))
    sig = torch.ones((1, 2))
    assert torch.equal(sk.batched_stencil_spmv_lminor(Xm, coeff, sig),
                       sk.batched_stencil_spmv_lminor_plain(Xm, coeff, sig))
    assert sk.LAUNCHES["batched_stencil_spmv_lminor_cuda"] == 0
    with pytest.raises(ValueError, match="must lie on"):
        sk.batched_stencil_spmv_lminor_cuda(Xm, coeff, sig)


# ── solvers on the coarse step04 case ─────────────────────────────────


@pytest.fixture(scope="module")
def coarse():
    jcase, params, mesh = jax_pressure_case(coarse=True, with_mesh=True)
    sc = jst.build_stencil_case(jcase, mesh)
    tables = np.array(sigma_tables_for_sweep(jcase, params))
    out = jst.batched_stencil_solve_fused(sc, jnp.asarray(tables[LANES]),
                                          tol=TOL, maxiter=30_000,
                                          use_pallas=False)
    d = {k: np.asarray(getattr(sc, k)) for k in
         ("coeff", "free", "dirichlet", "b_neumann", "grid_index",
          "sigma_table")}
    return dict(sc=sc, tables=tables, out=out,
                icase=interop.stencil_case_from_numpy(d, device="cpu"))


@pytest.mark.parametrize("lane_minor", [False, True])
def test_fused_sweep_matches_reference(coarse, lane_minor):
    """Both routes of batched_stencil_solve_fused vs the reference's
    lane-major fused Jacobi sweep (4 lanes, f64): certified, iterations
    within 2, phi within 1e-7 max|phi|."""
    ref = coarse["out"]
    got = tst.batched_stencil_solve_fused(
        coarse["icase"], torch.as_tensor(coarse["tables"][LANES]), tol=TOL,
        maxiter=30_000, lane_minor=lane_minor)
    assert bool(got.converged.all())
    assert float(got.residual.max()) <= TOL
    np.testing.assert_array_less(
        np.abs(got.iterations.numpy() - np.asarray(ref.iterations)), 3)
    p_ref = np.asarray(ref.phi)
    assert tuple(got.phi.shape) == p_ref.shape
    np.testing.assert_allclose(got.phi.numpy(), p_ref, rtol=0,
                               atol=1e-7 * np.abs(p_ref).max())


def test_solve_stencil_matches_reference(coarse):
    """The single-case Jacobi-PCG (kernel 3's route), f64: the same
    iterations and phi to 1e-10 max|phi|."""
    tab = coarse["tables"][7]
    ref = jst.solve_stencil(coarse["sc"], jnp.asarray(tab), tol=TOL)
    got = tst.solve_stencil(coarse["icase"], torch.as_tensor(tab), tol=TOL)
    assert bool(got.converged)
    assert abs(int(got.iterations) - int(ref.iterations)) <= 2
    p_ref = np.asarray(ref.phi)
    np.testing.assert_allclose(got.phi.numpy(), p_ref, rtol=0,
                               atol=1e-10 * np.abs(p_ref).max())


def test_solve_stencil_refined_matches_reference(coarse):
    """The certified mixed-precision single solve on one lane: true f64
    residual <= 1e-8 and phi within 1e-7 max|phi|.  Its iteration count
    is not compared: the f32 inner CG on this 7000x-contrast system
    follows its rounding, and reordered f32 sums move the count by far
    more than the +-2 the f64 solvers hold."""
    tab = coarse["tables"][7]
    ref = jst.solve_stencil_refined(coarse["sc"], jnp.asarray(tab), tol=TOL)
    got = tst.solve_stencil_refined(coarse["icase"], torch.as_tensor(tab),
                                    tol=TOL)
    assert bool(got.converged) and float(got.residual) <= TOL
    p_ref = np.asarray(ref.phi)
    np.testing.assert_allclose(got.phi.numpy(), p_ref, rtol=0,
                               atol=1e-7 * np.abs(p_ref).max())


def test_jacobi_pcg_matches_reference():
    rng = np.random.default_rng(13)
    n = 40
    A = rng.standard_normal((n, n))
    A = A @ A.T + n * np.eye(n)
    b = rng.standard_normal(n)
    diag = np.diag(A).copy()
    diag[3] = 0.0                      # a zero diagonal takes minv = 1
    jr = jsolve.jacobi_pcg(lambda x: jnp.asarray(A) @ x, jnp.asarray(b),
                           jnp.asarray(diag), jnp.zeros(n), tol=1e-10)
    At = torch.as_tensor(A)
    tr = tsolve.jacobi_pcg(lambda x: At @ x, torch.as_tensor(b),
                           torch.as_tensor(diag),
                           torch.zeros(n, dtype=torch.float64), tol=1e-10)
    assert int(tr.iterations) == int(jr.iterations)
    np.testing.assert_allclose(tr.phi.numpy(), np.asarray(jr.phi),
                               rtol=1e-9, atol=1e-12)


def test_batched_cg_lane_minor_frozen_lane_stays_finite():
    """Lanes on the last axis: a lane with a zero right-hand side is done
    at once, and torch.where keeps its discarded 0/0 out of the state."""
    rng = np.random.default_rng(14)
    b = torch.as_tensor(rng.standard_normal((4, 3, 3, 2)))
    b[..., 1] = 0.0
    x, r, k = tsolve.batched_cg(lambda v: 2.0 * v, b, lambda v: v,
                                torch.zeros_like(b), tol=1e-10, maxiter=50,
                                lane_dim=-1)
    assert bool(torch.isfinite(x).all()) and bool(torch.isfinite(r).all())
    assert torch.equal(x[..., 1], torch.zeros_like(x[..., 1]))
    assert k.tolist() == [1, 0]
    torch.testing.assert_close(x[..., 0], b[..., 0] / 2.0)


def test_batched_cg_lane_at_maxiter_iterates_on_like_the_reference():
    """Only convergence freezes a lane: as in the reference's _fused_pcg,
    a lane at its maxiter iterates on while another lane still runs.
    Per-lane maxiter [4, 40, 40]; lane 2 converges at once."""
    from pelvistim_fem_tpu.ops import multigrid as jmg
    rng = np.random.default_rng(3)
    D = rng.uniform(1.0, 1e3, (3, 60, 1, 1))
    D[2] = 2.0
    b = rng.standard_normal((3, 60, 1, 1))
    maxiter = np.array([4, 40, 40])
    jx, jk = jmg._fused_pcg(lambda v: jnp.asarray(D) * v, jnp.asarray(b),
                            lambda v: v, jnp.zeros(b.shape), tol=1e-10,
                            maxiter=jnp.asarray(maxiter))
    Dt, bt = torch.as_tensor(D), torch.as_tensor(b)
    tx, _, tk = tsolve.batched_cg(lambda v: Dt * v, bt, lambda v: v,
                                  torch.zeros_like(bt), tol=1e-10,
                                  maxiter=torch.as_tensor(maxiter))
    assert tk.tolist() == np.asarray(jk).tolist()
    assert int(tk[0]) > 4 and int(tk[2]) == 1
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-9,
                               atol=1e-12)


def test_batched_cg_certify_restarts_drifted_lanes():
    """f32 CG on a condition-1e3 system: the recursive residual meets
    1e-5 while the true one does not.  stencil._certified_cg restarts
    those lanes until the true residual meets it, returns the true
    residual, and stops once each lane that misses it has spent its
    maxiter (a lane may run past its own while another lane runs, as in
    batched_cg)."""
    rng = np.random.default_rng(0)
    n = 200
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = torch.tensor((Q * np.logspace(0, 3, n)) @ Q.T, dtype=torch.float32)
    b = torch.tensor(rng.standard_normal((3, n)), dtype=torch.float32)
    op = lambda v: v @ A.T
    rel = lambda x: (b - op(x)).norm(dim=1) / b.norm(dim=1)
    x, _, k = tsolve.batched_cg(op, b, lambda v: v, torch.zeros_like(b),
                                tol=1e-5, maxiter=2000)
    assert bool((rel(x) > 1e-5).any())           # the recursion drifted
    x, r, kc = tst._certified_cg(op, b, lambda v: v, torch.zeros_like(b),
                                 tol=1e-5, maxiter=2000)
    assert torch.equal(r, b - op(x))
    assert bool((rel(x) <= 1e-5).all())
    assert bool((kc >= k).all()) and int(kc.max()) <= 2000
    xm, _, km = tst._certified_cg(op, b, lambda v: v, torch.zeros_like(b),
                                  tol=1e-7, maxiter=300)
    assert bool((rel(xm) > 1e-7).any())          # unattainable in f32
    assert bool((km >= 300).all())               # and every lane capped
