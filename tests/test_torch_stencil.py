"""PyTorch port: the stencil operator and the plain twins of the CUDA
stencil kernels, against the JAX package.

The twins are what a CPU tensor runs.  They are held against the Pallas
kernels they stand beside (run in interpret mode, as tests/test_pallas.py
runs them) in f32, and against the XLA formulations in f64."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.experimental import pallas as pl  # noqa: E402

import pelvistim_fem_tpu.ops.pallas_stencil as ps  # noqa: E402
from pelvistim_fem_tpu.ops import stencil as jst  # noqa: E402

from pelvistim_fem_tpu_torch.ops import stencil as tst  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F32 = dict(rtol=2e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=0)


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


def test_offsets_match_reference():
    assert tst.OFFSETS == jst.OFFSETS
    assert tst.DIAG_OFFSET == jst.DIAG_OFFSET == 13


@pytest.mark.parametrize("shape", [(8, 7, 6), (20, 13, 9), (31, 16, 8),
                                   (9, 5, 4)])
def test_spmv_twin_matches_flat_kernel_f32(shape):
    """Twin of kernel 1 vs the Pallas stencil_spmv_flat (f32)."""
    rng = np.random.default_rng(3)
    x_t, x_j = _rand(rng, shape, torch.float32)
    C_t, C_j = _rand(rng, (27,) + shape, torch.float32)
    ref = np.asarray(ps.stencil_spmv_flat(x_j, ps.pack_coeff_flat(C_j)))
    y = tst.stencil_spmv(x_t, C_t)
    assert y.dtype == torch.float32
    np.testing.assert_allclose(y.numpy(), ref, **F32)


@pytest.mark.parametrize("shape", [(8, 7, 6), (20, 13, 9), (31, 16, 8)])
def test_spmv_twin_matches_xla_f64(shape):
    rng = np.random.default_rng(0)
    x_t, x_j = _rand(rng, shape, torch.float64)
    C_t, C_j = _rand(rng, (27,) + shape, torch.float64)
    np.testing.assert_allclose(tst.stencil_spmv(x_t, C_t).numpy(),
                               np.asarray(jst.stencil_spmv(x_j, C_j)),
                               **F64)


@pytest.mark.parametrize("shape,L,B", [((9, 7, 6), 4, 3),
                                       ((17, 12, 9), 6, 5)])
def test_batched_twin_matches_flat_kernel_f32(shape, L, B):
    """Twin of kernel 2 vs the Pallas batched_stencil_spmv_flat (f32)."""
    rng = np.random.default_rng(3)
    X_t, X_j = _rand(rng, (L,) + shape, torch.float32)
    c_t, c_j = _rand(rng, (B, 27) + shape, torch.float32)
    tab = rng.random((L, B + 1))
    ref = np.asarray(ps.batched_stencil_spmv_flat(
        X_j, ps.pack_coeff_flat_bodies(c_j), jnp.asarray(tab, jnp.float32)))
    y = tst.batched_stencil_spmv_fused(X_t, c_t,
                                       torch.as_tensor(tab, dtype=torch.float32))
    np.testing.assert_allclose(y.numpy(), ref, **F32)


@pytest.mark.parametrize("L,B,shape", [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)),
                                       (2, 1, (6, 5, 4))])
def test_batched_twin_matches_xla_f64(L, B, shape):
    rng = np.random.default_rng(1)
    X_t, X_j = _rand(rng, (L,) + shape, torch.float64)
    c_t, c_j = _rand(rng, (B, 27) + shape, torch.float64)
    tab = rng.random((L, B + 1))
    ref = np.asarray(jst.batched_stencil_spmv_fused(X_j, c_j,
                                                    jnp.asarray(tab)))
    y = tst.batched_stencil_spmv_fused(X_t, c_t, torch.as_tensor(tab))
    np.testing.assert_allclose(y.numpy(), ref, **F64)


def test_spmv_twin_neighbor_directions():
    """A one-hot C picks exactly the right neighbour, zero outside."""
    shape = (6, 5, 4)
    rng = np.random.default_rng(4)
    xn = rng.standard_normal(shape)
    x = torch.as_tensor(xn)
    for o, (dx, dy, dz) in enumerate(tst.OFFSETS):
        C = torch.zeros((27,) + shape, dtype=torch.float64)
        C[o] = 1.0
        expect = np.pad(xn, 1)[1 + dx:1 + dx + shape[0],
                               1 + dy:1 + dy + shape[1],
                               1 + dz:1 + dz + shape[2]]
        np.testing.assert_array_equal(sk.stencil_spmv_plain(x, C).numpy(),
                                      expect, err_msg=f"offset {o}")


@pytest.mark.parametrize("B", [1, 5])
def test_combine_coeffs_matches_reference(B):
    rng = np.random.default_rng(2)
    coeff = rng.standard_normal((B, 27, 5, 4, 3))
    sig = np.concatenate([[0.0], rng.random(B)])
    ref = np.asarray(jst.combine_coeffs(jnp.asarray(coeff),
                                        jnp.asarray(sig)))
    got = tst.combine_coeffs(torch.as_tensor(coeff), torch.as_tensor(sig))
    np.testing.assert_allclose(got.numpy(), ref, **F64)


def test_combine_coeffs_rejects_stale_table():
    """A pre-combined B == 1 stack with a full-length table raises instead
    of silently scaling by sigma[1]."""
    coeff = torch.ones((1, 27, 3, 3, 3))
    with pytest.raises(ValueError):
        tst.combine_coeffs(coeff, torch.ones(6))


def test_operator_matches_reference():
    """(op, diag, b_eff) of the projected system vs the JAX _operator."""
    rng = np.random.default_rng(5)
    shape = (7, 6, 5)
    B = 3
    d = dict(coeff=rng.standard_normal((B, 27) + shape),
             free=rng.random(shape) > 0.3,
             dirichlet=rng.standard_normal(shape),
             b_neumann=rng.standard_normal(shape),
             grid_index=np.arange(int(np.prod(shape))),
             sigma_table=np.concatenate([[0.0], rng.random(B)]))
    jcase = jst.StencilCase(**{k: jnp.asarray(v) for k, v in d.items()})
    from pelvistim_fem_tpu_torch.interop import stencil_case_from_numpy
    tcase = stencil_case_from_numpy(d, device="cpu")
    jop, jdiag, jb = jst._operator(jcase, jcase.sigma_table)
    top, tdiag, tb = tst._operator(tcase, tcase.sigma_table)
    x = rng.standard_normal(shape)
    np.testing.assert_allclose(top(torch.as_tensor(x)).numpy(),
                               np.asarray(jop(jnp.asarray(x))), **F64)
    np.testing.assert_allclose(tdiag.numpy(), np.asarray(jdiag), **F64)
    np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **F64)


def test_cpu_tensors_take_the_twin():
    """Dispatch is by device: CPU tensors never launch a kernel, and the
    CUDA wrappers refuse CPU tensors before building anything."""
    sk.reset_launches()
    x = torch.ones((4, 3, 3))
    C = torch.ones((27, 4, 3, 3))
    assert torch.equal(sk.stencil_spmv(x, C), sk.stencil_spmv_plain(x, C))
    Xs = torch.ones((2, 4, 3, 3))
    coeff = torch.ones((1, 27, 4, 3, 3))
    sig = torch.ones((2, 1))
    assert torch.equal(sk.batched_stencil_spmv(Xs, coeff, sig),
                       sk.batched_stencil_spmv_plain(Xs, coeff, sig))
    Cb = C.to(torch.bfloat16)
    assert torch.equal(sk.stencil_spmv_bf16c(x, Cb),
                       sk.stencil_spmv_bf16c_plain(x, Cb))
    assert torch.equal(sk.plane_fma(x, C, 3), sk.plane_fma_plain(x, C, 3))
    free = torch.ones((4, 3, 3), dtype=torch.bool)
    assert torch.equal(sk.coarse_cg(x, C, free, 2),
                       sk.coarse_cg_plain(x, C, free, 2))
    assert torch.equal(sk.combine_lanes(coeff, sig),
                       sk.combine_lanes_plain(coeff, sig))
    lv = sk.LevelOp(C, free)
    assert torch.equal(sk.level_apply(x, x, lv, "sweep"),
                       sk.level_apply_plain(x, x, lv, "sweep"))
    flv = sk.FactoredLevelOp(coeff, sig, free[None])
    assert torch.equal(sk.level_apply_factored(Xs, Xs, flv, "sweep"),
                       sk.level_apply_factored_plain(Xs, Xs, flv, "sweep"))
    assert sk.LAUNCHES == {"stencil_spmv_cuda": 0,
                           "batched_stencil_spmv_cuda": 0,
                           "batched_stencil_spmv_lminor_cuda": 0,
                           "stencil_spmv_bf16c_cuda": 0,
                           "plane_fma_cuda": 0,
                           "coarse_cg_cuda": 0,
                           "vcycle_tail_cuda": 0,
                           "cluster_tail_cuda": 0,
                           "combine_lanes_cuda": 0,
                           "level_apply_cuda": 0,
                           "restrict_cuda": 0,
                           "prolong_add_cuda": 0,
                           "level_apply_factored_cuda": 0}
    with pytest.raises(ValueError, match="must lie on"):
        sk.stencil_spmv_cuda(x, C)
    with pytest.raises(ValueError, match="must lie on"):
        sk.stencil_spmv_bf16c_cuda(x, Cb)
    with pytest.raises(ValueError, match="must lie on"):
        sk.plane_fma_cuda(x, C, 3)
    with pytest.raises(ValueError, match="must lie on"):
        sk.batched_stencil_spmv_cuda(Xs, coeff, sig)
    with pytest.raises(ValueError, match="must lie on"):
        sk.coarse_cg_cuda(x, C, free, 2)
    with pytest.raises(ValueError, match="must lie on"):
        sk.combine_lanes_cuda(coeff, sig)
    with pytest.raises(ValueError, match="must lie on"):
        sk.level_apply_cuda(x, x, lv, "sweep")
    with pytest.raises(ValueError, match="must lie on"):
        sk.level_apply_factored_cuda(Xs, Xs, flv, "sweep")


PTXAS_REPORT = """\
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af34batched_stencil_spmv_lminor_kernelIdLi5ELi32EEvPKT_S3_S3_PS1_iiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af34batched_stencil_spmv_lminor_kernelIdLi5ELi32EEvPKT_S3_S3_PS1_iiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 56 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af27batched_stencil_spmv_kernelIfLi8ELi3ELi64EEvPKT_S3_S3_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af27batched_stencil_spmv_kernelIfLi8ELi3ELi64EEvPKT_S3_S3_PS1_iiii
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af19stencil_spmv_kernelIfEEvPKT_S3_PS1_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af19stencil_spmv_kernelIfEEvPKT_S3_PS1_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 34 registers, used 0 barriers
"""


def test_ptxas_usage_reads_the_report(tmp_path, monkeypatch):
    """ptxas_usage names each kernel instantiation by its template
    arguments and reads its registers and spilled bytes (no nvcc here:
    the report of a build is written by hand)."""
    monkeypatch.setattr(sk, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(sk, "build", lambda extra_flags=(): None)
    sk._library_path(("-DX=1",)).with_suffix(".ptxas.txt").write_text(
        PTXAS_REPORT)
    assert sk.ptxas_usage(("-DX=1",)) == {
        "batched_stencil_spmv_lminor_kernel<double,5,32>":
            {"registers": 56, "spill_bytes": 0},
        "batched_stencil_spmv_kernel<float,8,3,64>":
            {"registers": 64, "spill_bytes": 20},
        "stencil_spmv_kernel<float>": {"registers": 34, "spill_bytes": 0}}
    assert sk._library_path(("-DX=1",)) != sk._library_path(())


@pytest.mark.parametrize("name", ["stencil_spmv_cuda",
                                  "batched_stencil_spmv_cuda",
                                  "batched_stencil_spmv_lminor_cuda"])
def test_kernel_inputs_fit_their_kernels(name):
    """measure.kernel_inputs gives each kernel its own layout of one
    random problem: the twins of the two batched layouts agree through a
    transpose, and sigma is positive."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    shape = (6, 5, 4) if name == "stencil_spmv_cuda" else (7, 3, (6, 5, 4))
    args = measure.kernel_inputs(name, shape, torch.float64, "cpu",
                                 np.random.default_rng(3))
    twin = getattr(sk, name.replace("_cuda", "_plain"))
    y = twin(*args)
    assert y.shape == args[0].shape
    if name == "stencil_spmv_cuda":
        return
    assert bool((args[2] > 0).all())
    other = ("batched_stencil_spmv_lminor_cuda"
             if name == "batched_stencil_spmv_cuda"
             else "batched_stencil_spmv_cuda")
    args2 = measure.kernel_inputs(other, shape, torch.float64, "cpu",
                                  np.random.default_rng(3))
    y2 = getattr(sk, other.replace("_cuda", "_plain"))(*args2)
    if name == "batched_stencil_spmv_cuda":
        y2 = y2.permute(3, 0, 1, 2)
    else:
        y2 = y2.permute(1, 2, 3, 0)
    np.testing.assert_allclose(y2.numpy(), y.numpy(), **F64)
