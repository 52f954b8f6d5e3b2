"""PyTorch port on a CUDA card: the stencil kernels against their plain
twins, and small sweeps and metric rows on the card against the CPU.

Marked `cuda`; every test skips where no CUDA device is present.  On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import itertools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.cuda

F32 = dict(rtol=2e-5, atol=1e-5)
F64 = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


def _rand(rng, shape, dtype, dev):
    return torch.as_tensor(rng.standard_normal(shape), dtype=dtype,
                           device=dev)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("shape", [(8, 7, 6), (20, 13, 9), (31, 16, 8),
                                   (9, 5, 4)])
def test_stencil_kernel_matches_twin(dev, dtype, shape):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(0)
    x = _rand(rng, shape, dt, dev)
    C = _rand(rng, (27,) + shape, dt, dev)
    y = sk.stencil_spmv_cuda(x, C)
    torch.testing.assert_close(y, sk.stencil_spmv_plain(x, C),
                               **(F32 if dtype == "float32" else F64))


# The batched kernels' edges: grids whose point count is no multiple of a
# block's points ((9, 7, 5), the sweep's (89, 41, 19)), lane counts that
# fill no lane group, block or slab (1, 15, 25, 33, 40, 600), 1 and 8
# bodies.
EDGES = [(1, 1, (9, 7, 5)), (15, 5, (9, 7, 5)), (25, 8, (9, 7, 5)),
         (33, 1, (9, 7, 5)), (40, 8, (9, 7, 5)), (25, 5, (89, 41, 19)),
         (15, 1, (89, 41, 19)), (600, 2, (5, 4, 3))]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L,B,shape", [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)),
                                       (40, 3, (9, 7, 6)), (1, 8, (5, 4, 3))]
                         + EDGES)
def test_batched_kernel_matches_twin(dev, dtype, L, B, shape):
    """Includes L > 32 (two lane blocks) and the 8-body limit."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(1)
    Xs = _rand(rng, (L,) + shape, dt, dev)
    coeff = _rand(rng, (B, 27) + shape, dt, dev)
    sig = torch.as_tensor(rng.random((L, B)), dtype=dt, device=dev)
    y = sk.batched_stencil_spmv_cuda(Xs, coeff, sig)
    torch.testing.assert_close(y, sk.batched_stencil_spmv_plain(Xs, coeff,
                                                                sig),
                               **(F32 if dtype == "float32" else F64))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L,B,shape", [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)),
                                       (15, 5, (9, 7, 6)), (33, 1, (5, 4, 3)),
                                       (1, 8, (6, 5, 4))] + EDGES)
def test_lminor_kernel_matches_twin(dev, dtype, L, B, shape):
    """Lane counts that are not multiples of 32, one body and the 8-body
    limit."""
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(5)
    Xm = _rand(rng, shape + (L,), dt, dev)
    coeff = _rand(rng, (B, 27) + shape, dt, dev)
    sig = torch.as_tensor(rng.random((B, L)), dtype=dt, device=dev)
    y = sk.batched_stencil_spmv_lminor_cuda(Xm, coeff, sig)
    torch.testing.assert_close(
        y, sk.batched_stencil_spmv_lminor_plain(Xm, coeff, sig),
        **(F32 if dtype == "float32" else F64))


def test_lminor_kernel_counts_and_refuses(dev):
    sk.reset_launches()
    Xm = torch.ones((4, 3, 3, 2), device=dev)
    coeff = torch.ones((1, 27, 4, 3, 3), device=dev)
    sk.batched_stencil_spmv_lminor(Xm, coeff, torch.ones((1, 2), device=dev))
    assert sk.LAUNCHES["batched_stencil_spmv_lminor_cuda"] == 1
    with pytest.raises(ValueError):      # sig given lane-major
        sk.batched_stencil_spmv_lminor_cuda(Xm, coeff,
                                            torch.ones((2, 1), device=dev))
    with pytest.raises(TypeError):
        sk.batched_stencil_spmv_lminor_cuda(Xm.double(), coeff,
                                            torch.ones((1, 2), device=dev))
    assert sk.LAUNCHES["batched_stencil_spmv_lminor_cuda"] == 1


def test_kernels_spill_no_registers(dev):
    """ptxas -v of the build: no kernel instantiation (kernel 1, both
    batched kernels at every dtype and body count, the bf16-coefficient
    kernel, the plane-FMA probe's 3-row form and its 1-row form at P = 1,
    27 and any, with and without 16-byte loads, and the coarse CG at
    1-8 points a thread with its coefficients in shared or device
    memory, the V-cycle tail and the cluster tail in both dtypes, the
    lanes' combine at
    every dtype and body count, and the level kernels: level_apply in
    its four modes and its "prolong_sweep" kernel, restrict at its two
    tiles and prolong_add, in both dtypes; the
    body-factored level kernel at every dtype and body count, from x and
    from zero, and its march at every dtype, body count and stage, x
    staged or wd b formed) spills to local memory."""
    usage = sk.ptxas_usage()
    assert len(usage) == 2 + 2 * 2 * 8 + 1 + 2 + 2 * 3 * 2 + 2 * 4 * 2 + 2 \
        + 2 + 2 * 8 + 2 * 4 + 2 * 2 + 2 + 2 + 2 * 8 * 2 + 2 * 8 * 2, \
        sorted(usage)
    assert {"stencil_spmv_bf16c_kernel", "plane_fma_kernel<float>",
            "plane_fma_kernel<double>", "plane_fma_row_kernel<float,27,4>",
            "plane_fma_row_kernel<double,0,1>",
            "coarse_cg_kernel<float,1,1>",
            "coarse_cg_kernel<double,8,0>", "vcycle_tail_kernel<float>",
            "vcycle_tail_kernel<double>", "cluster_tail_kernel<float>",
            "cluster_tail_kernel<double>", "combine_lanes_kernel<float,5>",
            "combine_lanes_kernel<double,8>", "level_apply_kernel<float,0>",
            "level_apply_kernel<double,3>", "restrict_kernel<float,2,4>",
            "restrict_kernel<double,4,8>", "prolong_add_kernel<double>",
            "level_prolong_sweep_kernel<float>",
            "level_prolong_sweep_kernel<double>",
            "level_apply_factored_kernel<float,5,4,64,0>",
            "level_apply_factored_kernel<double,5,2,32,1>",
            "level_march_kernel<float,5,4,0>", "level_march_kernel<float,3,4,1>",
            "level_march_kernel<double,5,2,1>",
            "level_march_kernel<double,8,1,0>"} <= set(usage)
    spilled = {k: u for k, u in usage.items() if u["spill_bytes"]}
    assert not spilled


def test_stencil_kernel_neighbor_directions(dev):
    shape = (6, 5, 4)
    x = _rand(np.random.default_rng(4), shape, torch.float64, dev)
    for o in range(27):
        C = torch.zeros((27,) + shape, dtype=x.dtype, device=dev)
        C[o] = 1.0
        assert torch.equal(sk.stencil_spmv_cuda(x, C),
                           sk.stencil_spmv_plain(x, C)), o


def test_wrappers_count_and_refuse(dev):
    sk.reset_launches()
    x = torch.ones((4, 3, 3), device=dev)
    C = torch.ones((27, 4, 3, 3), device=dev)
    sk.stencil_spmv(x, C)
    assert sk.LAUNCHES["stencil_spmv_cuda"] == 1
    with pytest.raises(TypeError):
        sk.stencil_spmv_cuda(x, C.double())
    with pytest.raises(ValueError):
        sk.stencil_spmv_cuda(x.transpose(0, 1), C)
    Xs = torch.ones((2, 4, 3, 3), device=dev)
    with pytest.raises(ValueError):
        sk.batched_stencil_spmv_cuda(Xs, torch.ones((9, 27, 4, 3, 3),
                                                    device=dev),
                                     torch.ones((2, 9), device=dev))
    assert sk.LAUNCHES["stencil_spmv_cuda"] == 1


def test_coarse_sweep_on_card_matches_cpu(dev):
    from pelvistim_fem_tpu_torch.models.pressure import (build_pressure_spec,
                                                         sigma_tables)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
        assemble_lattice
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_mg_solve_fused_refined_chunked as sweep
    spec, _ = build_pressure_spec(coarse=True)
    tabs = sigma_tables(spec, [5e-5, 5e-3, 0.5])
    outs = []
    for d in ("cpu", dev):
        scase, hier = assemble_lattice(spec, torch.float64, device=d)
        outs.append(sweep(scase, hier, torch.as_tensor(tabs, device=d),
                          lanes_per_chunk=2, tol=1e-8))
    cpu, card = outs
    assert bool(card.converged.all())
    assert float(card.residual.max()) <= 1e-8
    ref = cpu.phi.abs().max()
    assert float((card.phi.cpu() - cpu.phi).abs().max()) <= 1e-6 * ref


def _coarse_jacobi_case(d):
    from pelvistim_fem_tpu_torch.models.pressure import build_pressure_spec
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
        assemble_lattice
    spec, params = build_pressure_spec(coarse=True)
    scase, _ = assemble_lattice(spec, torch.float64, device=d)
    return spec, params, scase


def test_fused_jacobi_routes_agree_on_card(dev):
    """Lane-major and lane-minor Jacobi sweeps on the card (kernels
    batched_stencil_spmv_cuda and batched_stencil_spmv_lminor_cuda) agree
    with each other and with the CPU twins."""
    from pelvistim_fem_tpu_torch.models.pressure import sigma_tables
    from pelvistim_fem_tpu_torch.ops.stencil import \
        batched_stencil_solve_fused as fused
    outs = {}
    for d in ("cpu", dev):
        spec, params, scase = _coarse_jacobi_case(d)
        tabs = torch.as_tensor(sigma_tables(
            spec, params["pressure_sweep"]["sigma_contact_Spm"][::4]),
            device=d)
        for lm in (False, True):
            r = fused(scase, tabs, tol=1e-8, maxiter=30_000, lane_minor=lm)
            assert bool(r.converged.all())
            outs[(str(d), lm)] = r
    ref = outs[("cpu", False)]
    scale = float(ref.phi.abs().max())
    for key, r in outs.items():
        assert (r.iterations.cpu() - ref.iterations).abs().max() <= 2, key
        assert float((r.phi.cpu() - ref.phi).abs().max()) <= 1e-7 * scale


def test_metric_rows_on_card_match_cpu(dev):
    """The coarse Case and batched metric rows: card (f32, as the
    benchmark extracts) against the CPU."""
    from pelvistim_fem_tpu_torch.models.pressure import (
        build_pressure_case, sigma_tables_for_sweep)
    from pelvistim_fem_tpu_torch.ops.metrics import extract_results_batched
    from pelvistim_fem_tpu_torch.ops.stencil import \
        batched_stencil_solve_fused as fused
    _, _, scase = _coarse_jacobi_case("cpu")
    rows = {}
    for d in ("cpu", dev):
        case, params = build_pressure_case(coarse=True, dtype=torch.float32,
                                           device=d)
        tabs = sigma_tables_for_sweep(case, params)[::7]
        if d == "cpu":
            phis = fused(scase, tabs.double(), tol=1e-8,
                         maxiter=30_000).phi.float()
        rows[str(d)] = extract_results_batched(
            case, phis.to(d), params, sigma_tables=tabs,
            pressure_labels=["a", "b", "c"], sigma_contacts=[1.0, 2.0, 3.0])
    for g, w in zip(rows[str(dev)], rows["cpu"]):
        assert list(g) == list(w)
        for k, b in w.items():
            a = g[k]
            if isinstance(b, (bool, str)) or b is None:
                assert a == b, k
            elif k == "flux_err_consistent":
                assert abs(a - b) <= 1e-5, k
            else:
                np.testing.assert_allclose(a, b, rtol=1e-5, equal_nan=True,
                                           err_msg=k)


# Kernel 1's lane axis: S lanes, each its own stencil, in one launch; S = 1
# and grids whose point count is no multiple of a block's 256 points.
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("S,shape", [(1, (8, 7, 6)), (3, (9, 7, 5)),
                                     (8, (20, 13, 9)), (5, (31, 16, 8))])
def test_stencil_kernel_lanes_match_twin(dev, dtype, S, shape):
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(S)
    x = _rand(rng, (S,) + shape, dt, dev)
    C = _rand(rng, (S, 27) + shape, dt, dev)
    y = sk.stencil_spmv_cuda(x, C)
    torch.testing.assert_close(y, sk.stencil_spmv_plain(x, C),
                               **(F32 if dtype == "float32" else F64))
    # lanes never mix: each lane is the 3-D kernel on that lane
    for s in range(S):
        assert torch.equal(y[s], sk.stencil_spmv_cuda(x[s].contiguous(),
                                                      C[s].contiguous()))


def test_stencil_kernel_lanes_count_and_refuse(dev):
    sk.reset_launches()
    x = torch.ones((3, 4, 3, 3), device=dev)
    sk.stencil_spmv(x, torch.ones((3, 27, 4, 3, 3), device=dev))
    assert sk.LAUNCHES["stencil_spmv_cuda"] == 1
    with pytest.raises(ValueError):      # a shared 4-D stencil
        sk.stencil_spmv_cuda(x, torch.ones((27, 4, 3, 3), device=dev))
    with pytest.raises(ValueError):      # lane counts differ
        sk.stencil_spmv_cuda(x, torch.ones((2, 27, 4, 3, 3), device=dev))
    with pytest.raises(RuntimeError):    # more lanes than gridDim.y takes
        sk.stencil_spmv_cuda(torch.ones((65536, 1, 1, 1), device=dev),
                             torch.ones((65536, 27, 1, 1, 1), device=dev))
    assert sk.LAUNCHES["stencil_spmv_cuda"] == 1


def test_group_mg_solve_on_card_matches_cpu(dev):
    """The step02 --quick padded group: card against CPU, both certified,
    the same iterations within 2 and phi within 1e-6 max|phi|."""
    from pelvistim_fem_tpu_torch.models.electrodes import \
        build_electrode_case
    from pelvistim_fem_tpu_torch.ops.multigrid import \
        batched_group_solve_mg_refined
    from pelvistim_fem_tpu_torch.parallel.geometry_sweep import (
        build_padded_group, build_padded_group_hierarchy)
    out = {}
    for d in ("cpu", dev):
        built = [build_electrode_case(shape=s, r=0.01, with_mesh=True,
                                      device=d)[::2]
                 for s in ("circle", "square")]
        stacked, _ = build_padded_group(built, device=d)
        r = batched_group_solve_mg_refined(
            stacked, build_padded_group_hierarchy(stacked), tol=1e-8,
            maxiter=30_000)
        assert bool(r.converged.all()) and float(r.residual.max()) <= 1e-8
        out[str(d)] = r
    g, c = out[str(dev)], out["cpu"]
    assert int((g.iterations.cpu() - c.iterations).abs().max()) <= 2
    scale = float(c.phi.abs().max())
    assert float((g.phi.cpu() - c.phi).abs().max()) <= 1e-6 * scale


# The probes: the plane-FMA kernel (27 planes on 3 x rows, P planes on 1)
# and kernel 1 with bf16 coefficients, 3-D and with lanes, X = 1 and grids
# that end mid-block.
PROBE_GRIDS = [(1, 7, 6), (9, 7, 5), (20, 13, 9), (3, 9, 7, 5),
               (2, 31, 16, 8)]


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("P,xrows", [(27, 3), (1, 1), (27, 1), (5, 1)])
@pytest.mark.parametrize("grid", PROBE_GRIDS)
def test_plane_fma_kernel_matches_twin(dev, dtype, P, xrows, grid):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    args = measure.kernel_inputs("plane_fma_cuda", (P, xrows, grid),
                                 getattr(torch, dtype), dev,
                                 np.random.default_rng(P + len(grid)))
    torch.testing.assert_close(sk.plane_fma_cuda(*args),
                               sk.plane_fma_plain(*args),
                               **(F32 if dtype == "float32" else F64))


@pytest.mark.parametrize("grid", PROBE_GRIDS)
def test_bf16c_kernel_matches_twin(dev, grid):
    """At f32 tolerance against the twin fed the same bf16 coefficients,
    and bit for bit kernel 1 on those coefficients widened (one body,
    one order of multiply-adds)."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    x, Cb = measure.kernel_inputs("stencil_spmv_bf16c_cuda", grid,
                                  torch.float32, dev,
                                  np.random.default_rng(len(grid)))
    y = sk.stencil_spmv_bf16c_cuda(x, Cb)
    torch.testing.assert_close(y, sk.stencil_spmv_bf16c_plain(x, Cb), **F32)
    assert torch.equal(y, sk.stencil_spmv_cuda(x, Cb.float()))


def test_probe_wrappers_count_and_refuse(dev):
    sk.reset_launches()
    x = torch.ones((4, 3, 3), device=dev)
    C = torch.ones((27, 4, 3, 3), device=dev)
    sk.plane_fma(x, C, 3)
    sk.stencil_spmv_bf16c(x, C.to(torch.bfloat16))
    assert sk.LAUNCHES["plane_fma_cuda"] == 1
    assert sk.LAUNCHES["stencil_spmv_bf16c_cuda"] == 1
    with pytest.raises(TypeError):       # f32 coefficients: no quiet cast
        sk.stencil_spmv_bf16c_cuda(x, C)
    with pytest.raises(TypeError):
        sk.stencil_spmv_bf16c_cuda(x.double(), C.to(torch.bfloat16))
    with pytest.raises(ValueError):      # 3 x rows take 27 planes
        sk.plane_fma_cuda(x, C[:5].contiguous(), 3)
    with pytest.raises(ValueError):
        sk.plane_fma_cuda(x, C, 2)
    with pytest.raises(TypeError):
        sk.plane_fma_cuda(x, C.double(), 1)
    assert sk.LAUNCHES["plane_fma_cuda"] == 1
    assert sk.LAUNCHES["stencil_spmv_bf16c_cuda"] == 1


@pytest.mark.parametrize("threads", [128, 512])
def test_plane_fma_block_sizes_match_twin(dev, threads):
    """The roofline probe's other builds (PST_PROBE_THREADS) compute the
    same function."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.roofline_probe import probe_flags
    args = measure.kernel_inputs("plane_fma_cuda", (27, 3, (9, 7, 5)),
                                 torch.float32, dev,
                                 np.random.default_rng(threads))
    y = sk.launch("plane_fma_cuda", *args, extra_flags=probe_flags(threads))
    torch.testing.assert_close(y, sk.plane_fma_plain(*args), **F32)


# The 1-row plane-FMA form: P = 1 and 27 (unrolled) and 2 and 5 (the
# runtime count), with 16-byte loads (G a multiple of 4) and without (G
# odd, or x and C starting one element past an aligned address).
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("P", [1, 2, 5, 27])
@pytest.mark.parametrize("grid", [(3, 5, 7), (4, 6, 5), (2, 9, 7, 4)])
def test_plane_fma_row_forms_match_twin(dev, dtype, P, grid):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    dt = getattr(torch, dtype)
    x, C, _ = measure.kernel_inputs("plane_fma_cuda", (P, 1, grid), dt, dev,
                                    np.random.default_rng(P))
    y = sk.plane_fma_cuda(x, C, 1)
    torch.testing.assert_close(y, sk.plane_fma_plain(x, C, 1),
                               **(F32 if dtype == "float32" else F64))

    def shifted(a):                     # contiguous, 1 element off
        buf = torch.empty(a.numel() + 1, dtype=dt, device=dev)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        return out

    xs, Cs = shifted(x), shifted(C)
    assert xs.data_ptr() % 16 and Cs.data_ptr() % 16
    # the scalar and the vector bodies sum each point in one order
    assert torch.equal(sk.plane_fma_cuda(xs, Cs, 1), y)


# The coarse CG: the step04 (5, 3, 3), megatet (5, 4, 3) and step02 (10,
# 5, 2) coarsest shapes, S = 1 and 8, a mask shared by the lanes, and
# (16, 11, 11), past shared memory for the coefficients (1,936 points: 8
# a thread, the coefficients in device memory).
@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("grid", [(5, 3, 3), (1, 5, 4, 3), (8, 10, 5, 2),
                                  (8, 5, 3, 3), (16, 11, 11),
                                  (2, 16, 11, 11)])
def test_coarse_cg_kernel_matches_twin(dev, dtype, grid):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    args = measure.kernel_inputs("coarse_cg_cuda", (24, grid),
                                 getattr(torch, dtype), dev,
                                 np.random.default_rng(len(grid)))
    measure.check_coarse_cg(f"coarse_cg {grid}", sk.coarse_cg_cuda(*args),
                            args)


def test_coarse_cg_kernel_shared_mask_and_zero_lane(dev):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    b, C, free, iters = measure.kernel_inputs(
        "coarse_cg_cuda", (24, (8, 5, 3, 3)), torch.float32, dev,
        np.random.default_rng(3))
    b[3] = 0.0
    args = (b, C, free[:1].contiguous(), iters)
    x = sk.coarse_cg_cuda(*args)
    measure.check_coarse_cg("coarse_cg shared mask", x, args)
    assert torch.equal(x[3], torch.zeros_like(x[3]))
    # lanes never mix: each lane is the kernel on that lane alone
    for s in (0, 5):
        assert torch.equal(x[s], sk.coarse_cg_cuda(
            b[s].contiguous(), C[s].contiguous(), free[0].contiguous(),
            iters))


def test_coarse_cg_wrapper_counts_and_refuses(dev):
    sk.reset_launches()
    b = torch.ones((5, 3, 3), device=dev)
    C = torch.ones((27, 5, 3, 3), device=dev)
    free = torch.ones((5, 3, 3), dtype=torch.bool, device=dev)
    sk.coarse_cg(b, C, free, 24)
    assert sk.LAUNCHES["coarse_cg_cuda"] == 1
    with pytest.raises(TypeError):       # a float mask
        sk.coarse_cg_cuda(b, C, free.float(), 24)
    with pytest.raises(ValueError):      # a mask of another grid
        sk.coarse_cg_cuda(b, C, free[:4].contiguous(), 24)
    with pytest.raises(ValueError):
        sk.coarse_cg_cuda(b, C, free, -1)
    with pytest.raises(ValueError):      # past 2048 points a lane
        sk.coarse_cg_cuda(torch.ones((17, 16, 16), device=dev),
                          torch.ones((27, 17, 16, 16), device=dev),
                          torch.ones((17, 16, 16), dtype=torch.bool,
                                     device=dev), 24)
    assert sk.LAUNCHES["coarse_cg_cuda"] == 1


# The V-cycle tail: the paths' tails (step04's app hierarchy, the
# megatet's, step02's 8 lanes), f64 from the first level that fits, and
# small hierarchies that fit whole, 3-D and with 3 lanes.
TAILS = {"float32": [(1, [(15, 9, 6), (8, 5, 4), (5, 3, 3)]),
                     (1, [(15, 10, 6), (8, 6, 4), (5, 4, 3)]),
                     (8, [(18, 8, 3), (10, 5, 2)]),
                     (1, [(9, 7, 5), (5, 4, 3), (3, 3, 2)]),
                     (3, [(7, 4, 6), (4, 3, 4), (3, 2, 3)])],
         "float64": [(1, [(8, 5, 4), (5, 3, 3)]),
                     (1, [(8, 6, 4), (5, 4, 3)]),
                     (8, [(18, 8, 3), (10, 5, 2)]),
                     (1, [(9, 7, 5), (5, 4, 3), (3, 3, 2)])]}


@pytest.mark.parametrize("dtype,case", [(d, c) for d, cs in TAILS.items()
                                        for c in cs])
def test_vcycle_tail_kernel_matches_twin(dev, dtype, case):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    S, shapes = case
    args = measure.kernel_inputs("vcycle_tail_cuda", (2, 24, S, shapes),
                                 getattr(torch, dtype), dev,
                                 np.random.default_rng(S + len(shapes)))
    measure.check_vcycle_tail(f"vcycle_tail {case}",
                              sk.vcycle_tail_cuda(*args), args)


def test_vcycle_tail_equals_the_level_route(dev):
    """One V-cycle through the tail is bit for bit the level-by-level
    route (kernel 1, PyTorch's elementwise ops, coarse_cg_cuda) from every
    tail level, on the coarse step04 hierarchy (f32 and f64) and on two
    lanes with their own stencils and masks (_fused_cycle); the default
    V-cycle's one launch is the cluster tail from the level above the
    tail (this hierarchy has one in both dtypes), the tail from
    tail_start's level the vcycle_tail kernel."""
    from pelvistim_fem_tpu_torch.models.pressure import (build_pressure_spec,
                                                         sigma_tables)
    from pelvistim_fem_tpu_torch.ops import multigrid as tmg
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
        assemble_lattice
    spec, _ = build_pressure_spec(coarse=True)
    _, hier = assemble_lattice(spec, torch.float64, device=dev)
    tabs = torch.as_tensor(sigma_tables(spec, [5e-5, 0.5]), device=dev)
    n = len(hier.levels)
    rng = np.random.default_rng(5)
    free = hier.levels[0].free
    for dt in (torch.float32, torch.float64):
        h = hier.astype(dt)
        b = torch.where(free, _rand(rng, tuple(free.shape), dt, dev), 0.0)
        want = tmg.make_v_cycle(h, tabs[0].to(dt), tail_from=n)(b)
        shapes = [tuple(lv.free.shape) for lv in h.levels]
        t0 = tmg.tail_start(shapes, dt)
        assert t0 < n - 1 and tmg.cluster_tail_plan(shapes, dt)[0] == t0 - 1
        sk.reset_launches()
        assert torch.equal(tmg.make_v_cycle(h, tabs[0].to(dt))(b), want)
        assert sk.LAUNCHES["cluster_tail_cuda"] == 1
        assert sk.LAUNCHES["vcycle_tail_cuda"] == 0
        assert sk.LAUNCHES["coarse_cg_cuda"] == 0
        for t in range(t0, n - 1):
            sk.reset_launches()
            assert torch.equal(tmg.make_v_cycle(h, tabs[0].to(dt),
                                                tail_from=t)(b), want), t
            assert sk.LAUNCHES["vcycle_tail_cuda"] == 1
    h = hier.astype(torch.float32)
    stacked = tmg.MGHierarchy(
        levels=tuple(tmg.MGLevel(
            coeff=torch.stack([lv.coeff, 1.5 * lv.coeff]),
            free=torch.stack([lv.free, lv.free & torch.as_tensor(
                rng.random(tuple(lv.free.shape)) < 0.9, device=dev)]))
            for lv in h.levels),
        transfers=h.transfers)
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, tabs.float())
              for lv in stacked.levels]
    B = torch.where(stacked.levels[0].free,
                    _rand(rng, (2,) + tuple(free.shape), torch.float32,
                          dev), 0.0)
    want = tmg._fused_cycle(pieces, stacked, B, tail_from=n)
    sk.reset_launches()
    assert torch.equal(tmg._fused_cycle(pieces, stacked, B), want)
    assert sk.LAUNCHES["cluster_tail_cuda"] == 1
    assert sk.LAUNCHES["vcycle_tail_cuda"] == 0
    assert sk.LAUNCHES["coarse_cg_cuda"] == 0
    t0 = tmg.tail_start([tuple(lv.free.shape[-3:]) for lv in h.levels],
                        torch.float32)
    sk.reset_launches()
    assert torch.equal(tmg._fused_cycle(pieces, stacked, B, tail_from=t0),
                       want)
    assert sk.LAUNCHES["vcycle_tail_cuda"] == 1


def test_vcycle_tail_wrapper_counts_and_refuses(dev):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    shapes = [(9, 7, 5), (5, 4, 3), (3, 3, 2)]
    b, tail, nu, omega, iters = measure.kernel_inputs(
        "vcycle_tail_cuda", (2, 24, 1, shapes), torch.float32, dev,
        np.random.default_rng(6))
    sk.reset_launches()
    sk.vcycle_tail(b, tail, nu, omega, iters)
    assert sk.LAUNCHES["vcycle_tail_cuda"] == 1
    with pytest.raises(ValueError, match="must lie on"):
        sk.vcycle_tail_cuda(b.cpu(), tail, nu, omega, iters)
    with pytest.raises(TypeError):
        sk.vcycle_tail_cuda(b.double(), tail, nu, omega, iters)
    with pytest.raises(ValueError):      # not the top level's grid
        sk.vcycle_tail_cuda(b[:8].contiguous(), tail, nu, omega, iters)
    with pytest.raises(ValueError):
        sk.vcycle_tail_cuda(b, tail, -1, omega, iters)
    big = measure.kernel_inputs("vcycle_tail_cuda",
                                (2, 24, 1, [(17, 16, 16), (9, 9, 9)]),
                                torch.float32, dev, np.random.default_rng(7))
    assert sk.vcycle_tail_smem(big[1].shapes, torch.float32) > sk.SMEM_MAX
    with pytest.raises(ValueError, match="shared memory"):
        sk.vcycle_tail_cuda(*big)
    assert sk.LAUNCHES["vcycle_tail_cuda"] == 1


def test_vcycle_tail_smem_matches_library(dev):
    """The Python mirror of the kernel's shared-memory formula equals
    pst_vcycle_tail_smem, and the library's limits equal the module's."""
    import ctypes
    lib = sk.build()
    assert lib.pst_max_smem() == sk.SMEM_MAX
    assert lib.pst_tail_max_levels() == sk.TAIL_MAX_LEVELS
    assert lib.pst_coarse_cg_max_points() == sk.COARSE_CG_MAX_POINTS
    for shapes in ([(15, 9, 6), (8, 5, 4), (5, 3, 3)], [(5, 3, 3)],
                   [(28, 16, 10), (15, 9, 6), (8, 5, 4), (5, 3, 3)],
                   [(18, 8, 3), (10, 5, 2)]):
        layout = [len(shapes)] + [d for s in shapes for d in s]
        arr = (ctypes.c_int * len(layout))(*layout)
        for dt in (torch.float32, torch.float64):
            es = torch.finfo(dt).bits // 8
            assert lib.pst_vcycle_tail_smem(arr, es) == \
                sk.vcycle_tail_smem(shapes, dt), (shapes, dt)


# The cluster tail: the paths' levels from the one above the tail (step04's
# app hierarchy, the megatet's, step02's 8 lanes), and edges: 11 planes
# over 7 slab ranks (slabs of 2 and 1, X < 2 N, ranks without a coarse
# plane to restrict) and 10 planes over 3 (4, 3, 3) with 3 lanes; f64 from
# the level above its tail.
CLUSTERS = {"float32": [(1, [(28, 16, 10), (15, 9, 6), (8, 5, 4),
                              (5, 3, 3)], 8),
                        (1, [(29, 18, 11), (15, 10, 6), (8, 6, 4),
                             (5, 4, 3)], 8),
                        (8, [(34, 15, 5), (18, 8, 3), (10, 5, 2)], 8),
                        (1, [(11, 7, 5), (6, 4, 3), (4, 3, 2)], 8),
                        (3, [(10, 8, 6), (6, 5, 4), (4, 3, 3)], 4)],
            "float64": [(1, [(15, 9, 6), (8, 5, 4), (5, 3, 3)], 8),
                        (8, [(34, 15, 5), (18, 8, 3), (10, 5, 2)], 8),
                        (1, [(11, 7, 5), (6, 4, 3), (4, 3, 2)], 8)]}


@pytest.mark.parametrize("dtype,case", [(d, c) for d, cs in CLUSTERS.items()
                                        for c in cs])
def test_cluster_tail_kernel_matches_twin_and_route(dev, dtype, case):
    """The cluster tail on random SPD levels within check_cluster_tail of
    vcycle_tail_plain over the same levels, and torch.equal to the route
    it repeats (the level route at the top level: kernel 1 and PyTorch's
    ops; vcycle_tail_cuda below), at nu 2 and 1."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    S, shapes, ranks = case
    args = measure.kernel_inputs("cluster_tail_cuda",
                                 (2, 24, S, shapes, ranks),
                                 getattr(torch, dtype), dev,
                                 np.random.default_rng(S + ranks))
    assert args[1].plan.ranks == ranks
    y = sk.cluster_tail_cuda(*args)
    measure.check_cluster_tail(f"cluster_tail {case}", y, args)
    assert torch.equal(y, measure.cluster_route(*args))
    one = (args[0], args[1], 1) + args[3:]
    assert torch.equal(sk.cluster_tail_cuda(*one),
                       measure.cluster_route(*one))


def test_cluster_tail_wrapper_counts_and_refuses(dev):
    """One launch counted per call; CPU tensors, another dtype, a b off
    the top level, a negative nu and a plan the kernel refuses (9 ranks)
    raise, uncounted."""
    import dataclasses
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    b, ct, nu, omega, iters = measure.kernel_inputs(
        "cluster_tail_cuda", (2, 24, 1, [(11, 7, 5), (6, 4, 3), (4, 3, 2)]),
        torch.float32, dev, np.random.default_rng(8))
    sk.reset_launches()
    sk.cluster_tail(b, ct, nu, omega, iters)
    assert sk.LAUNCHES["cluster_tail_cuda"] == 1
    with pytest.raises(ValueError, match="must lie on"):
        sk.cluster_tail_cuda(b.cpu(), ct, nu, omega, iters)
    with pytest.raises(TypeError):
        sk.cluster_tail_cuda(b.double(), ct, nu, omega, iters)
    with pytest.raises(ValueError):
        sk.cluster_tail_cuda(b[:8].contiguous(), ct, nu, omega, iters)
    with pytest.raises(ValueError):
        sk.cluster_tail_cuda(b, ct, -1, omega, iters)
    bad = dataclasses.replace(ct, plan=dataclasses.replace(ct.plan, ranks=9))
    with pytest.raises(RuntimeError, match="launch failed"):
        sk.cluster_tail_cuda(b, bad, nu, omega, iters)
    assert sk.LAUNCHES["cluster_tail_cuda"] == 1


def test_cluster_tail_smem_matches_library(dev):
    """The Python plan's bytes a block equal pst_cluster_tail_smem at 2-8
    ranks (-1 where the kernel refuses the plan: more slab ranks than
    planes; bytes past SMEM_MAX the Python plan refuses)."""
    import ctypes
    lib = sk.build()
    assert lib.pst_cluster_max_ranks() == sk.CLUSTER_MAX_RANKS
    for shapes in ([(28, 16, 10), (15, 9, 6), (8, 5, 4), (5, 3, 3)],
                   [(29, 18, 11), (15, 10, 6), (8, 6, 4), (5, 4, 3)],
                   [(34, 15, 5), (18, 8, 3), (10, 5, 2)],
                   [(5, 7, 5), (3, 4, 3), (2, 3, 2)]):
        tail = [len(shapes) - 1] + [d for g in shapes[1:] for d in g]
        top = [2] + list(shapes[0]) + list(shapes[1])
        arr = (ctypes.c_int * len(tail))(*tail)
        arr_top = (ctypes.c_int * len(top))(*top)
        for dt in (torch.float32, torch.float64):
            es = torch.finfo(dt).bits // 8
            for ranks in range(2, 9):
                got = lib.pst_cluster_tail_smem(arr, arr_top, ranks, es)
                plan = sk.cluster_plan(shapes, dt, ranks)
                if plan is not None:
                    assert got == plan.smem, (shapes, dt, ranks)
                elif shapes[0][0] < ranks - 1:
                    assert got == -1
                else:
                    assert got > sk.SMEM_MAX, (shapes, dt, ranks)


# ── the level kernels ───────────────────────────────────────────────────


def _coarse04(dev):
    from pelvistim_fem_tpu_torch.models.pressure import (build_pressure_spec,
                                                         sigma_tables)
    from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
        assemble_lattice
    spec, _ = build_pressure_spec(coarse=True)
    scase, hier = assemble_lattice(spec, torch.float64, device=dev)
    tabs = torch.as_tensor(sigma_tables(spec, [5e-5, 0.5]), device=dev)
    return scase, hier, tabs


def _level_hierarchy(hier, tabs, dt, kind, rng, dev):
    """(LevelOps, hierarchy): one operator, or two lanes with their own
    stencils and a shared ("shared") or per-lane ("lanes") mask."""
    from pelvistim_fem_tpu_torch.ops import multigrid as tmg
    h = hier.astype(dt)
    sig = tabs.to(dt)
    if kind == "one":
        return [tmg._level_op(lv, sig[0]) for lv in h.levels], h
    levels = []
    for lv in h.levels:
        free = lv.free[None]
        if kind == "lanes":
            free = torch.stack([lv.free, lv.free & torch.as_tensor(
                rng.random(tuple(lv.free.shape)) < 0.9, device=dev)])
        levels.append(tmg.MGLevel(coeff=torch.stack([lv.coeff,
                                                     1.5 * lv.coeff]),
                                  free=free))
    st = tmg.MGHierarchy(levels=tuple(levels), transfers=h.transfers)
    return [tmg._fused_level_pieces(lv.coeff, lv.free, sig)[5]
            for lv in st.levels], st


@pytest.mark.parametrize("kind", ["one", "shared", "lanes"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_level_kernels_match_twin_and_route(dev, dtype, kind):
    """At every level of the coarse step04 hierarchy above the coarsest:
    level_apply_cuda in each mode within measure.check_close of its twin
    (the f32 / f64 tolerances with atol relative to max|twin|: a sweep
    scales the apply's rounding by omega / diag, up to ~1e6 here) and
    torch.equal to the card's route (kernel 1 and PyTorch's ops; mode
    "prolong_sweep": prolong_add's ops, then the sweep's);
    restrict_cuda and prolong_add_cuda torch.equal to their twins (the
    route's own ops)."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(60)
    _, hier, tabs = _coarse04(dev)
    levels, h = _level_hierarchy(hier, tabs, dt, kind, rng, dev)
    for l in range(len(levels) - 1):
        lv, nxt = levels[l], levels[l + 1]
        shape = tuple(lv.C.shape[:-4]) + tuple(lv.C.shape[-3:])
        x = _rand(rng, shape, dt, dev)
        b = torch.where(lv.free, _rand(rng, shape, dt, dev), 0.0)
        tt = h.transfers[l].kernel_tables(dev, dt)
        xc = _rand(rng, shape[:-3] + tuple(nxt.C.shape[-3:]), dt, dev)
        for mode in sk.LEVEL_MODES:
            args = (x, b, lv, mode, 0.7) + (
                (xc, tt) if mode == "prolong_sweep" else ())
            y = sk.level_apply_cuda(*args)
            measure.check_close(f"level {l} {mode}", y,
                                sk.level_apply_plain(*args), dt)
            assert torch.equal(y, sk.level_apply_plain(
                *args, spmv=sk.stencil_spmv_cuda)), (l, mode)
        assert torch.equal(sk.restrict_cuda(b, tt, nxt.free),
                           sk.restrict_plain(b, tt, nxt.free))
        assert torch.equal(sk.prolong_add_cuda(x, xc, tt),
                           sk.prolong_add_plain(x, xc, tt))


# the prolongation's edges (chip_smoke's TRANSFER_EDGES): prolong_add on
# grids odd and even along each axis (units cut by the grid's end, slots
# clamped at the coarse grid's end), long along z, with 1, 3, 25 and 64
# lanes; "prolong_sweep" at the megatet's fine grid
PROLONG_EDGES = [("prolong_add_cuda", ((9, 13, 37),)),
                 ("prolong_add_cuda", ((3, 10, 8, 34),)),
                 ("prolong_add_cuda", ((1, 9, 13, 70),)),
                 ("prolong_add_cuda", ((25, 11, 7, 5),)),
                 ("prolong_add_cuda", ((25, 12, 7, 70),)),
                 ("prolong_add_cuda", ((64, 7, 9, 66),)),
                 ("level_apply_cuda", ("prolong_sweep", 1, (112, 68, 41)))]


@pytest.mark.parametrize("name,shape", PROLONG_EDGES)
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_prolong_kernels_at_tile_edges(dev, dtype, name, shape):
    """prolong_add_cuda torch.equal to prolong_add_plain, and
    "prolong_sweep" to prolong_add_plain then the "sweep" route, at the
    edges."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    rng = np.random.default_rng(61)
    args = measure.kernel_inputs(name, shape, getattr(torch, dtype), dev,
                                 rng)
    if name == "prolong_add_cuda":
        assert torch.equal(sk.prolong_add_cuda(*args),
                           sk.prolong_add_plain(*args))
    else:
        x, b, lv, _, omega, xc, tt = args
        want = sk.level_apply_plain(sk.prolong_add_plain(x, xc, tt), b, lv,
                                    "sweep", omega,
                                    spmv=sk.stencil_spmv_cuda)
        assert torch.equal(sk.level_apply_cuda(*args), want)


def test_v_cycles_through_the_level_kernels_equal_the_route(dev):
    """One V-cycle with the levels above the tail through the level
    kernels torch.equal to the route (route=True), f32 and f64, for one
    operator (make_v_cycle) and two lanes with their own stencils and
    masks (_fused_cycle); 5 launches a level above the V-cycle's one
    tail launch (the cluster tail's start: the prolongation in
    "prolong_sweep"), kernel 1 never; the CG's masked operator
    torch.equal to _operator's."""
    from pelvistim_fem_tpu_torch.ops import multigrid as tmg
    from pelvistim_fem_tpu_torch.ops import stencil as tst
    rng = np.random.default_rng(61)
    scase, hier, tabs = _coarse04(dev)
    for dt in (torch.float32, torch.float64):
        h = hier.astype(dt)
        t = tmg.cluster_tail_plan([tuple(lv.free.shape) for lv in h.levels],
                                  dt)[0]
        free = h.levels[0].free
        b = torch.where(free, _rand(rng, tuple(free.shape), dt, dev), 0.0)
        want = tmg.make_v_cycle(h, tabs[0].to(dt), route=True)(b)
        M = tmg.make_v_cycle(h, tabs[0].to(dt))
        sk.reset_launches()
        assert torch.equal(M(b), want)
        assert sk.LAUNCHES["stencil_spmv_cuda"] == 0
        assert sk.LAUNCHES["level_apply_cuda"] == 4 * t
        assert sk.LAUNCHES["restrict_cuda"] == t
        assert sk.LAUNCHES["prolong_add_cuda"] == 0
        levels, st = _level_hierarchy(hier, tabs, dt, "lanes", rng, dev)
        sig = tabs.to(dt)
        pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
                  for lv in st.levels]
        B = torch.where(pieces[0][2], _rand(rng, (2,) + tuple(free.shape),
                                            dt, dev), 0.0)
        want = tmg._fused_cycle(pieces, st, B, route=True)
        sk.reset_launches()
        assert torch.equal(tmg._fused_cycle(pieces, st, B), want)
        assert sk.LAUNCHES["stencil_spmv_cuda"] == 0
        assert sk.LAUNCHES["level_apply_cuda"] == 4 * t
        sc = scase.astype(dt)
        op, _, _ = tst._operator(sc, sc.sigma_table)
        x = _rand(rng, tuple(sc.free.shape), dt, dev)
        sk.reset_launches()
        assert torch.equal(tst._masked_operator(sc, sc.sigma_table)(x),
                           op(x))
        assert sk.LAUNCHES["level_apply_cuda"] == 1


def test_level_wrappers_count_and_refuse(dev):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    rng = np.random.default_rng(62)
    x, b, lv, mode, omega = measure.kernel_inputs(
        "level_apply_cuda", ("sweep", 1, (9, 7, 5)), torch.float32, dev, rng)
    r, tt, free_c = measure.kernel_inputs("restrict_cuda", (1, (9, 7, 5)),
                                          torch.float32, dev, rng)
    xc = torch.zeros(tt.shape[1], device=dev)
    sk.reset_launches()
    sk.level_apply(x, b, lv, "sweep")
    sk.level_apply(x, b, lv, "prolong_sweep", 0.7, xc, tt)
    sk.restrict(r, tt, free_c)
    sk.prolong_add(x, xc, tt)
    assert (sk.LAUNCHES["level_apply_cuda"], sk.LAUNCHES["restrict_cuda"],
            sk.LAUNCHES["prolong_add_cuda"]) == (2, 1, 1)
    with pytest.raises(ValueError, match="takes xc and tt"):
        sk.level_apply_cuda(x, b, lv, "prolong_sweep")
    with pytest.raises(ValueError):
        sk.level_apply_cuda(x, b, lv, "prolong_sweep", 0.7, xc[:2], tt)
    with pytest.raises(TypeError):
        sk.level_apply_cuda(x.double(), b.double(), lv, "sweep")
    with pytest.raises(ValueError):
        sk.level_apply_cuda(x[:8].contiguous(), b, lv, "residual")
    with pytest.raises(ValueError, match="mode"):
        sk.level_apply_cuda(x, b, lv, "jacobi")
    with pytest.raises(ValueError):
        sk.restrict_cuda(xc, tt, free_c)
    with pytest.raises(ValueError):
        sk.prolong_add_cuda(x, x, tt)
    with pytest.raises(TypeError):
        sk.restrict_cuda(r, tt, free_c.float())
    assert (sk.LAUNCHES["level_apply_cuda"], sk.LAUNCHES["restrict_cuda"],
            sk.LAUNCHES["prolong_add_cuda"]) == (2, 1, 1)


# ── the body-factored level kernel ──────────────────────────────────────

# The body-factored levels above the paths' tails: the sweep's three (25
# lanes) and step04's two (15 lanes), 5 bodies; the array's fine level at
# 8 and 64 lanes and its next at 64, 3 bodies.  Edges: lane counts that
# fill no lane group or slab (L not a multiple of the lanes a thread), 1
# and 8 bodies, Y x Z smaller than a tile, Z cut into tiles, X not a
# multiple of a segment.
FACTORED = [(25, 5, (89, 41, 19)), (25, 5, (45, 21, 10)),
            (25, 5, (23, 11, 6)), (15, 5, (55, 31, 19)),
            (15, 5, (28, 16, 10)), (8, 3, (71, 71, 24)),
            (64, 3, (71, 71, 24)), (64, 3, (36, 36, 13))]
FACTORED_EDGES = [(1, 1, (9, 7, 5)), (3, 8, (9, 7, 5)), (33, 1, (9, 7, 5)),
                  (40, 8, (9, 7, 5)), (25, 5, (5, 4, 3)), (2, 8, (6, 2, 2)),
                  (7, 2, (11, 40, 37)), (13, 4, (6, 3, 70)),
                  (11, 5, (37, 9, 8))]


def _factored_route(*args):
    return sk.level_apply_factored_plain(*args,
                                         spmv=sk.batched_stencil_spmv_cuda)


def _check_factored(dev, dtype, L, B, grid, seed):
    """Every mode of level_apply_factored_cuda within measure.check_close
    of its twin and torch.equal to the card's route (kernel 2 and
    PyTorch's ops)."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(seed)
    for mode in sk.FACTORED_MODES:
        args = measure.kernel_inputs("level_apply_factored_cuda",
                                     (mode, B, (L,) + grid), dt, dev, rng)
        if mode in ("sweep0", "masked"):
            args = (None if mode == "sweep0" else args[0],
                    None if mode == "masked" else args[1]) + args[2:]
        y = sk.level_apply_factored_cuda(*args)
        measure.check_close(f"factored {mode} {L} {B} {grid}", y,
                            sk.level_apply_factored_plain(*args), dt)
        assert torch.equal(y, _factored_route(*args)), mode


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L,B,grid", FACTORED)
def test_factored_level_kernel_matches_twin_and_route(dev, dtype, L, B,
                                                      grid):
    """level_apply_factored_cuda in each mode at the paths' body-factored
    levels, within measure.check_close of its twin and torch.equal to the
    card's route (kernel 2 and PyTorch's ops)."""
    _check_factored(dev, dtype, L, B, grid, 80)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L,B,grid", FACTORED_EDGES)
def test_factored_level_kernel_edges(dev, dtype, L, B, grid):
    _check_factored(dev, dtype, L, B, grid, 81)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L,B,grid", [(25, 5, (89, 41, 19)),
                                      (8, 3, (71, 71, 24)),
                                      (25, 5, (23, 11, 6))])
def test_factored_both_kernels_equal_the_route(dev, dtype, L, B, grid):
    """Each of the plan's two kernels forced, the march (march_blocks)
    and kernel 2's tiles, in every mode torch.equal to the card's route,
    whichever march_plan picks at the shape."""
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    from pelvistim_fem_tpu_torch.profile_kernels import factored_with
    dt = getattr(torch, dtype)
    rng = np.random.default_rng(84)
    tiles = sk.MarchPlan(0, 0, 0, 0, 0, 0, 0, 0, tiles=True)
    for mode in sk.FACTORED_MODES:
        args = measure.kernel_inputs("level_apply_factored_cuda",
                                     (mode, B, (L,) + grid), dt, dev, rng)
        if mode in ("sweep0", "masked"):
            args = (None if mode == "sweep0" else args[0],
                    None if mode == "masked" else args[1]) + args[2:]
        want = _factored_route(*args)
        for plan in (sk.march_blocks(L, B, grid, dt, mode), tiles):
            assert torch.equal(factored_with(plan)(*args), want), \
                (mode, plan)


def test_march_plan_matches_library(dev):
    """stencil_kernels' march formulas (march_lanes, march_smem,
    MARCH_MAX_THREADS) equal the library's (MarchSmem, march_lanes,
    kMarchMaxThreads) for every body count, dtype and mode at a few tiles
    (rows, depth along z, lanes)."""
    lib = sk.build()
    for B, (dt, es) in itertools.product(range(1, 9), (
            (torch.float32, 4), (torch.float64, 8))):
        assert lib.pst_march_max_threads(es) == sk.MARCH_MAX_THREADS[dt]
        assert lib.pst_march_lanes(B, es) == sk.march_lanes(B, dt)
        for (ty, Z, lanes), mode in itertools.product(
                ((1, 1, 1), (3, 19, 25), (2, 24, 64), (7, 5, 3)),
                sk.FACTORED_MODES):
            assert lib.pst_march_smem(ty, Z, lanes, B,
                                      sk.LEVEL_MODES[mode], es) == \
                sk.march_smem(ty, Z, lanes, B, dt, mode)


def test_factored_v_cycle_equals_the_route(dev):
    """One lane-stacked V-cycle of the coarse step04 hierarchy, three
    lanes, every level body-factored: through the level kernels
    torch.equal to the route (route=True: kernel 2 and PyTorch's ops),
    f32 and f64; 6 launches a level above the coarsest, kernel 2 there
    never; restrict_cuda with the lanes' one coarse mask."""
    from pelvistim_fem_tpu_torch.models.pressure import (build_pressure_spec,
                                                         sigma_tables)
    from pelvistim_fem_tpu_torch.ops import multigrid as tmg
    _, hier, _ = _coarse04(dev)
    spec, _ = build_pressure_spec(coarse=True)
    tabs = torch.as_tensor(sigma_tables(spec, [5e-5, 5e-3, 0.5]),
                           device=dev)
    rng = np.random.default_rng(82)
    n = len(hier.levels)
    for dt in (torch.float32, torch.float64):
        h = hier.astype(dt)
        pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, tabs.to(dt))
                  for lv in h.levels]
        B = torch.where(pieces[0][2], _rand(
            rng, (3,) + tuple(h.levels[0].free.shape), dt, dev), 0.0)
        want = tmg._fused_cycle(pieces, h, B, route=True)
        sk.reset_launches()
        assert torch.equal(tmg._fused_cycle(pieces, h, B), want)
        assert sk.LAUNCHES["level_apply_factored_cuda"] == 4 * (n - 1) + 24
        assert sk.LAUNCHES["restrict_cuda"] == n - 1
        assert sk.LAUNCHES["prolong_add_cuda"] == n - 1
        assert sk.LAUNCHES["batched_stencil_spmv_cuda"] == 0


def test_factored_wrapper_counts_and_refuses(dev):
    from pelvistim_fem_tpu_torch.ops.kernels import measure
    x, b, lv, mode, omega = measure.kernel_inputs(
        "level_apply_factored_cuda", ("sweep", 5, (4, 9, 7, 5)),
        torch.float32, dev, np.random.default_rng(83))
    sk.reset_launches()
    sk.level_apply_factored(x, b, lv, "sweep")
    assert sk.LAUNCHES["level_apply_factored_cuda"] == 1
    with pytest.raises(TypeError):
        sk.level_apply_factored_cuda(x.double(), b.double(), lv, "sweep")
    with pytest.raises(ValueError):
        sk.level_apply_factored_cuda(x[:3].contiguous(), b, lv, "residual")
    with pytest.raises(ValueError, match="must lie on"):
        sk.level_apply_factored_cuda(x.cpu(), b.cpu(), lv, "sweep")
    with pytest.raises(ValueError, match="mode"):
        sk.level_apply_factored_cuda(x, b, lv, "jacobi")
    assert sk.LAUNCHES["level_apply_factored_cuda"] == 1
