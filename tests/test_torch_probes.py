"""The port's SpMV probes against the dev scripts' Pallas kernels.

The plain twins of the plane-FMA probe and of kernel 1 with bf16
coefficients (pelvistim_fem_tpu_torch/ops/kernels/stencil_kernels.py)
against spmv_noop, fma and spmv_slice of dev/spmv_kernels_ab.py and
dev/roofline_probe.py, run on the CPU in Pallas interpret mode; the
probes' bounds, inputs and argument checks; ptxas's report read by entry
name; and the A/B entry point at its small size on the CPU.  The CUDA
kernels themselves are held against these twins on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import ast
import importlib.util
from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

torch = pytest.importorskip("torch")

import pelvistim_fem_tpu.ops.pallas_stencil as ps  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import measure  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

ROOT = Path(__file__).resolve().parents[1]
RTOL = 2e-5          # f32, as tests/test_pallas.py


def _close(got, ref):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=RTOL,
                               atol=1e-5 * np.abs(ref).max())


@pytest.fixture(autouse=True)
def _interpret_mode(monkeypatch):
    if jax.devices()[0].platform == "cpu":
        orig = pl.pallas_call

        def interp(*a, **k):
            k["interpret"] = True
            return orig(*a, **k)

        monkeypatch.setattr(pl, "pallas_call", interp)
    yield


@pytest.fixture(scope="module")
def ab():
    """dev/spmv_kernels_ab.py, loaded by path (its main is guarded)."""
    path = ROOT / "dev" / "spmv_kernels_ab.py"
    spec = importlib.util.spec_from_file_location("dev_spmv_kernels_ab",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _roofline_fma(F):
    """fma of dev/roofline_probe.py, compiled alone with lane width F:
    the script runs its whole probe when imported, so only the
    definitions of mk_fma_kernel and fma are taken from it."""
    path = ROOT / "dev" / "roofline_probe.py"
    tree = ast.parse(path.read_text())
    body = [n for n in tree.body if isinstance(n, ast.FunctionDef)
            and n.name in ("mk_fma_kernel", "fma")]
    assert len(body) == 2
    ns = {"jax": jax, "jnp": jnp, "np": np, "pl": pl, "pltpu": pltpu,
          "F": F}
    exec(compile(ast.Module(body=body, type_ignores=[]), str(path), "exec"),
         ns)
    return ns["fma"]


def _inputs(shape, planes=27, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(np.float32)
    C = rng.standard_normal((planes,) + shape).astype(np.float32)
    return x, C


@pytest.mark.parametrize("shape", [(9, 6, 5), (8, 7, 6), (13, 5, 4)])
def test_three_row_probe_twin_matches_spmv_noop(ab, shape):
    """plane_fma_plain(x, C, 3) is spmv_noop on the natural layout: the 27
    planes times x rows i-1, i, i+1, zero outside the grid (X not a
    multiple of the Pallas block's 8 rows included)."""
    x, C = _inputs(shape)
    ref = ab.spmv_noop(jnp.asarray(x), ps.pack_coeff_flat(jnp.asarray(C),
                                                          rows=8), rows=8)
    _close(sk.plane_fma_plain(torch.as_tensor(x), torch.as_tensor(C), 3),
           ref)


@pytest.mark.parametrize("rows,planes", [(8, 1), (8, 27), (16, 27)])
def test_one_row_probe_twin_matches_roofline_fma(rows, planes):
    """plane_fma_plain(x, C, 1) is the roofline script's fma (P planes on
    one x row; P = 1 a copy), on x (Xr, 1, F)."""
    Xr, F = 16, 128
    x, C = _inputs((Xr, F), planes, seed=planes)
    ref = _roofline_fma(F)(jnp.asarray(x), jnp.asarray(C), rows, planes)
    got = sk.plane_fma_plain(torch.as_tensor(x).reshape(Xr, 1, F),
                             torch.as_tensor(C).reshape(planes, Xr, 1, F), 1)
    _close(got.reshape(Xr, F), ref)


@pytest.mark.parametrize("shape", [(9, 6, 5), (16, 7, 6)])
def test_bf16_coefficient_twin_matches_spmv_slice(ab, shape):
    """stencil_spmv_bf16c_plain is spmv_slice with bf16 coefficient planes
    cast to f32 for each FMA; both round the coefficients alike."""
    x, C = _inputs(shape, seed=2)
    Cj = jnp.asarray(C).astype(jnp.bfloat16)
    Cb = torch.as_tensor(C).to(torch.bfloat16)
    np.testing.assert_array_equal(np.asarray(Cj.astype(jnp.float32)),
                                  Cb.float().numpy())
    ref = ab.spmv_slice(jnp.asarray(x), ps.pack_coeff_flat(Cj, rows=8),
                        rows=8, cdtype="cast")
    _close(sk.stencil_spmv_bf16c_plain(torch.as_tensor(x), Cb), ref)


@pytest.mark.parametrize("shape", [(9, 6, 5), (16, 7, 6)])
def test_slice_kernel_f32_is_kernel_one(ab, shape):
    """spmv_slice in f32 computes kernel 1's function, so kernel 1 serves
    it: its twin stencil_spmv_plain matches."""
    x, C = _inputs(shape, seed=3)
    ref = ab.spmv_slice(jnp.asarray(x),
                        ps.pack_coeff_flat(jnp.asarray(C), rows=8), rows=8)
    _close(sk.stencil_spmv_plain(torch.as_tensor(x), torch.as_tensor(C)),
           ref)


def test_probe_twins_take_lanes_and_refuse():
    """A lane axis is the 3-D probe per lane; bad forms and dtypes raise
    (no cast), and CPU dispatch takes the twins."""
    x, C = _inputs((3, 5, 4, 3))
    x, C = torch.as_tensor(x), torch.as_tensor(C).permute(1, 0, 2, 3, 4)
    y = sk.plane_fma_plain(x, C.contiguous(), 3)
    for s in range(3):
        assert torch.equal(y[s], sk.plane_fma_plain(x[s], C[s], 3))
    with pytest.raises(ValueError):
        sk.plane_fma_plain(x[0], C[0, :5], 3)
    with pytest.raises(ValueError):
        sk.plane_fma(x[0], C[0], 2)
    Cb = C[0].to(torch.bfloat16)
    assert torch.equal(sk.stencil_spmv_bf16c(x[0], Cb),
                       sk.stencil_spmv_plain(x[0], Cb.float()))
    with pytest.raises(TypeError):
        sk.stencil_spmv_bf16c(x[0], C[0])
    with pytest.raises(TypeError):
        sk.stencil_spmv_bf16c_plain(x[0].double(), Cb)


def test_probe_bounds_at_the_megatet():
    """Bytes-bound at 3.35 TB/s: the 3-row probe moves kernel 1's bytes,
    the bf16 kernel 62 bytes a point, the copy 3 values a point."""
    g = (112, 68, 41)
    k1 = measure.bound("stencil_spmv_cuda", g, "float32")
    assert measure.bound("plane_fma_cuda", (27, 3, g), "float32") == k1
    assert round(k1[0], 4) == 0.0108
    bf, by = measure.bound("stencil_spmv_bf16c_cuda", g, "float32")
    assert (round(bf, 4), by) == (0.0058, "bytes")
    cp, _ = measure.bound("plane_fma_cuda", (1, 1, g), "float32")
    assert round(cp, 4) == 0.0011
    assert measure.bound("plane_fma_cuda", (27, 1, (3,) + g), "float64")[0] \
        == pytest.approx(6 * k1[0])
    assert measure.work("plane_fma_cuda", (5, 1, (2, 3, 4)), "float32") == \
        (7 * 24 * 4, 2 * 5 * 24)


@pytest.mark.parametrize("name,shape", [
    ("plane_fma_cuda", (27, 3, (4, 3, 2))),
    ("plane_fma_cuda", (5, 1, (2, 4, 3, 2))),
    ("stencil_spmv_bf16c_cuda", (2, 4, 3, 2))])
def test_probe_kernel_inputs(name, shape):
    """measure.kernel_inputs gives each probe its arguments: bf16 C for
    the bf16 kernel, xrows after x and C for the plane-FMA probe; the
    rotated copies keep xrows and clone the tensors."""
    args = measure.kernel_inputs(name, shape, torch.float32, "cpu",
                                 np.random.default_rng(0))
    twin = getattr(sk, name.replace("_cuda", "_plain"))
    assert twin(*args).shape == args[0].shape
    if name == "plane_fma_cuda":
        P, xrows, grid = shape
        assert args[2] == xrows
        assert tuple(args[1].shape) == grid[:-3] + (P,) + grid[-3:]
    else:
        assert args[1].dtype == torch.bfloat16
    copies = measure.input_copies(args)
    assert len(copies) >= 2
    for a, b in zip(args, copies[1]):
        if torch.is_tensor(a):
            assert b is not a and torch.equal(a, b)
        else:
            assert b == a


PTXAS_ENTRIES = """\
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af19stencil_spmv_kernelIfEEvPKT_S3_PS1_iii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af19stencil_spmv_kernelIfEEvPKT_S3_PS1_iii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 34 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af25stencil_spmv_bf16c_kernelEPKfPK13__nv_bfloat16Pfiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af25stencil_spmv_bf16c_kernelEPKfPK13__nv_bfloat16Pfiii
    0 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 30 registers, used 0 barriers
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af12stencil_pointIffEEvPKT_PKT0_PS1_iii
    8 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af16plane_fma_kernelIdEEvPKT_S3_PS1_iiiiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af16plane_fma_kernelIdEEvPKT_S3_PS1_iiiiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 26 registers, used 0 barriers
ptxas info    : Compiling entry function '_ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af27batched_stencil_spmv_kernelIfLi8ELi3ELi64EEEvPKT_S3_S3_PS1_iiii' for 'sm_90a'
ptxas info    : Function properties for _ZN43_GLOBAL__N__8e9900ae_10_stencil_cu_495321af27batched_stencil_spmv_kernelIfLi8ELi3ELi64EEEvPKT_S3_S3_PS1_iiii
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers
"""


def test_ptxas_report_read_by_entry_name():
    """Every entry reads under its own name: one whose name has digits
    and no template arguments (the bf16 kernel), a templated one after
    it, and no line of a function that is no entry is credited to the
    entry before it."""
    assert sk.parse_ptxas(PTXAS_ENTRIES) == {
        "stencil_spmv_kernel<float>": {"registers": 34, "spill_bytes": 0},
        "stencil_spmv_bf16c_kernel": {"registers": 30, "spill_bytes": 8},
        "plane_fma_kernel<double>": {"registers": 26, "spill_bytes": 0},
        "batched_stencil_spmv_kernel<float,8,3,64>":
            {"registers": 64, "spill_bytes": 20}}
    assert sk.demangle_kernel("_Z3fooILb1ELj7EEvv") == "foo<1,7>"


def test_spmv_kernels_ab_small_on_the_cpu(capsys):
    """The A/B entry point at --small on the CPU: its checks run on the
    twins (v0 is the twin there), no time is taken."""
    from pelvistim_fem_tpu_torch import spmv_kernels_ab
    out = spmv_kernels_ab.main(["--small", "--device", "cpu"])
    assert out["grid"] == (42, 27, 19) and out["rows"] == {}
    assert out["errors"]["v0"] == 0.0
    assert 1e-4 < out["errors"]["vbf16"] < 1e-2   # bf16 rounding, printed
    assert "not measured" in capsys.readouterr().out
