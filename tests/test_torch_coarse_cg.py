"""PyTorch port: the multigrid coarsest level's fixed CG (coarse_cg and
its plain twin) against the JAX package's one-level cycle_impl, a dense
numpy CG and its own lane form, on the CPU.

The CUDA kernel is held against the twin in tests/test_torch_cuda.py
(marked `cuda`) and in chip_smoke.py."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models.pressure import \
    build_pressure_spec as jax_pressure_spec  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import multigrid as jmg  # noqa: E402
from pelvistim_fem_tpu.ops.stencil import \
    combine_coeffs as jcombine  # noqa: E402

from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    build_pressure_spec, sigma_tables)
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import measure  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ITERS = 24                       # the V-cycles' coarse_iters
DT = {"float32": (torch.float32, jnp.float32),
      "float64": (torch.float64, jnp.float64)}


@pytest.fixture(scope="module")
def coarsest():
    """The coarsest level of the JAX hierarchy of the coarse step04
    lattice (tests/test_torch_multigrid.py's spec), f64, with the
    sigma tables of three contact levels."""
    jspec, _ = jax_pressure_spec(coarse=True)
    _, jhier = jla.assemble_lattice(jspec, jnp.float64)
    lv = jhier.levels[-1]
    tspec, _ = build_pressure_spec(coarse=True)
    tabs = sigma_tables(tspec, [5e-5, 5e-3, 0.5])
    return dict(coeff=np.asarray(lv.coeff), free=np.asarray(lv.free),
                tables=tabs, n_levels=len(jhier.levels))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_plain_matches_reference_one_level_cycle(coarsest, dtype):
    """One-level cycle_impl is exactly the coarse CG.  Same seeded inputs
    (the level's stencil combined by the JAX package, a right-hand side
    masked as the V-cycle masks it) through both.  The two packages
    order their sums differently, and 24 CG iterations pass each rounding
    on amplified by the level's conditioning (on the third lane the f64
    results differ by far more than f64's unit roundoff), so both dtypes
    are held to measure.check_coarse_cg's bound: 8x the twin's spread
    under one-ulp moves of its inputs, plus 2e-5 (f32) or 1e-12 (f64)
    max|x|; and below 1e-6 (f64) or 2e-3 (f32) max|x| in any case."""
    tdt, jdt = DT[dtype]
    assert coarsest["n_levels"] >= 3
    free = coarsest["free"]
    rng = np.random.default_rng(21)
    for k, tab in enumerate(coarsest["tables"]):
        C = np.asarray(jcombine(jnp.asarray(coarsest["coeff"]),
                                jnp.asarray(tab)))
        b = np.where(free, rng.standard_normal(free.shape), 0.0)
        level = jmg.MGLevel(coeff=jnp.asarray(C[None], jdt),
                            free=jnp.asarray(free))
        ops = [jmg._level_op(level, jnp.asarray([0.0, 1.0], jdt))]
        want = np.asarray(jax.jit(lambda r: jmg.cycle_impl(
            ops, [level.free], [], [], r, coarse_iters=ITERS))(
                jnp.asarray(b, jdt)))
        args = (torch.as_tensor(b, dtype=tdt), torch.tensor(C, dtype=tdt),
                torch.tensor(free), ITERS)
        got = sk.coarse_cg_plain(*args)
        assert got.dtype == tdt and tuple(got.shape) == free.shape
        err = measure.check_coarse_cg(f"reference lane {k}",
                                      torch.tensor(want), args)
        assert err <= (1e-6 if dtype == "float64" else 2e-3) * \
            np.abs(want).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_lane_form_matches_3d_calls(dtype):
    """S = 3 lanes, each its own stencil and mask, in one call against
    three 3-D calls."""
    tdt = DT[dtype][0]
    b, C, free, iters = measure.kernel_inputs(
        "coarse_cg_cuda", (ITERS, (3, 5, 4, 3)), tdt, "cpu",
        np.random.default_rng(22))
    assert not bool(free.all()) and bool(free.any())
    got = sk.coarse_cg_plain(b, C, free, iters)
    tol = dict(rtol=0, atol=(1e-5 if dtype == "float32" else 1e-13)
               * float(got.abs().max()))
    for s in range(3):
        torch.testing.assert_close(
            got[s], sk.coarse_cg_plain(b[s], C[s], free[s], iters), **tol)


def _dense_cg(b, C, free, iters):
    """Textbook Jacobi-preconditioned CG on the dense matrix of
    op(v) = where(free, K where(free, v, 0), v), numpy f64."""
    X, Y, Z = b.shape
    G = X * Y * Z
    A = np.eye(G)
    fr = free.reshape(-1)
    for p in np.flatnonzero(fr):
        i, j, k = np.unravel_index(p, (X, Y, Z))
        A[p, p] = 0.0
        for o, (dx, dy, dz) in enumerate(sk.OFFSETS):
            n = (i + dx, j + dy, k + dz)
            if all(0 <= a < m for a, m in zip(n, (X, Y, Z))):
                q = np.ravel_multi_index(n, (X, Y, Z))
                if fr[q]:
                    A[p, q] += C[o, i, j, k]
    d = np.diag(A)
    dinv = 1.0 / np.where(d != 0, d, 1.0)
    x, r = np.zeros(G), b.reshape(-1).copy()
    z = dinv * r
    p, rz = z.copy(), r @ z
    for _ in range(iters):
        ap = A @ p
        den = p @ ap
        alpha = rz / (den if den != 0 else 1.0)
        x, r = x + alpha * p, r - alpha * ap
        z = dinv * r
        rz_n = r @ z
        p = z + rz_n / (rz if rz != 0 else 1.0) * p
        rz = rz_n
    return x.reshape(b.shape)


@pytest.mark.parametrize("iters", [1, ITERS])
def test_plain_matches_dense_cg_with_masked_points(iters):
    """b on every point, free on 85% of them: a non-free point is an
    identity row, so it returns what CG gives an identity row (after one
    iteration, alpha * b there), not 0."""
    b, C, free, _ = measure.kernel_inputs(
        "coarse_cg_cuda", (iters, (6, 4, 3)), torch.float64, "cpu",
        np.random.default_rng(23))
    got = sk.coarse_cg_plain(b, C, free, iters).numpy()
    want = _dense_cg(b.numpy(), C.numpy(), free.numpy(), iters)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-12 * np.abs(want).max())
    nf = ~free.numpy()
    assert nf.any() and np.abs(got[nf]).min() > 0


def test_zero_lane_stays_finite_and_zero():
    """A lane whose b is 0 (a lane that has converged): rz and p.ap are 0
    at every iteration, and the zero guards keep alpha and beta finite."""
    b, C, free, iters = measure.kernel_inputs(
        "coarse_cg_cuda", (ITERS, (2, 5, 3, 3)), torch.float32, "cpu",
        np.random.default_rng(24))
    b[1] = 0.0
    x = sk.coarse_cg_plain(b, C, free, iters)
    assert bool(torch.isfinite(x).all())
    assert torch.equal(x[1], torch.zeros_like(x[1]))
    assert float(x[0].abs().max()) > 0
    assert torch.equal(sk.coarse_cg(b, C, free, iters), x)


def test_work_and_bound():
    """Bytes: b, 27 planes and x in the dtype plus a free byte a point;
    operations: 65 a point and iteration plus 4."""
    nbytes, ops = measure.work("coarse_cg_cuda", (ITERS, (5, 3, 3)),
                               "float32")
    assert (nbytes, ops) == (45 * (29 * 4 + 1), 45 * (65 * ITERS + 4))
    nbytes, ops = measure.work("coarse_cg_cuda", (ITERS, (8, 10, 5, 2)),
                               "float64")
    assert (nbytes, ops) == (800 * (29 * 8 + 1), 800 * (65 * ITERS + 4))
    ms, by = measure.bound("coarse_cg_cuda", (ITERS, (5, 3, 3)), "float32")
    assert by == "bytes"
    assert ms == pytest.approx(45 * 117 / measure.HBM_BYTES_PER_S * 1e3)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the twin: CPU tensors raise before
    any build."""
    b, C, free, iters = measure.kernel_inputs(
        "coarse_cg_cuda", (ITERS, (5, 3, 3)), torch.float32, "cpu",
        np.random.default_rng(25))
    with pytest.raises(ValueError, match="must lie on"):
        sk.coarse_cg_cuda(b, C, free, iters)


def test_v_cycles_run_their_coarsest_level_through_coarse_cg(monkeypatch):
    """make_v_cycle (one operator) and the per-lane _fused_cycle call
    coarse_cg once a cycle at their coarsest level; the body-factored
    _fused_cycle does not (it keeps the batched apply)."""
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
        assemble_lattice
    spec, _ = build_pressure_spec(coarse=True)
    scase, hier = assemble_lattice(spec, torch.float64, device="cpu")
    tabs = torch.as_tensor(sigma_tables(spec, [5e-5, 0.5]))
    calls = []

    def counted(b, C, free, iters):
        calls.append((tuple(b.shape), tuple(C.shape), tuple(free.shape)))
        return sk.coarse_cg_plain(b, C, free, iters)

    monkeypatch.setattr(tmg, "coarse_cg", counted)
    coarse = tuple(hier.levels[-1].free.shape)
    rng = np.random.default_rng(26)
    b = torch.as_tensor(rng.standard_normal(scase.free.shape))
    tmg.make_v_cycle(hier, tabs[0])(b)
    assert calls == [(coarse, (27,) + coarse, coarse)]
    calls.clear()
    stacked = tmg.MGHierarchy(
        levels=tuple(tmg.MGLevel(coeff=torch.stack([lv.coeff] * 2),
                                 free=torch.stack([lv.free] * 2))
                     for lv in hier.levels),
        transfers=hier.transfers)
    B = torch.stack([b, -b])
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, tabs)
              for lv in stacked.levels]
    tmg._fused_cycle(pieces, stacked, B)
    assert calls == [((2,) + coarse, (2, 27) + coarse, (2,) + coarse)]
    calls.clear()
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, tabs)
              for lv in hier.levels]
    tmg._fused_cycle(pieces, hier, B)
    assert calls == []


def test_ptxas_names_of_the_new_instantiations():
    """ptxas's report names the coarse CG and the 1-row probe by their
    template arguments (a bool argument reads 0 or 1)."""
    ns = "_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af"
    assert sk.demangle_kernel(
        ns + "16coarse_cg_kernelIfLi16ELb0EEEvPKT_S3_PKhPS1_iiiii") == \
        "coarse_cg_kernel<float,16,0>"
    assert sk.demangle_kernel(
        ns + "20plane_fma_row_kernelIdLi27ELi2EEEvPKT_S3_PS1_ii") == \
        "plane_fma_row_kernel<double,27,2>"
