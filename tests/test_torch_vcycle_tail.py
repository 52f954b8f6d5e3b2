"""PyTorch port: the V-cycle tail (vcycle_tail's plain twin, the level it
starts from and the kernel's shared-memory formula) against the port's
level-by-level V-cycles and the JAX package's make_v_cycle, on the CPU.

The CUDA kernel is held against the twin, and one V-cycle through it
against the level-by-level route bit for bit, in tests/test_torch_cuda.py
(marked `cuda`) and in chip_smoke.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from pelvistim_fem_tpu.models.pressure import \
    build_pressure_spec as jax_pressure_spec  # noqa: E402
from pelvistim_fem_tpu.ops import lattice_assembly as jla  # noqa: E402
from pelvistim_fem_tpu.ops import multigrid as jmg  # noqa: E402

from pelvistim_fem_tpu_torch import interop  # noqa: E402
from pelvistim_fem_tpu_torch.models.pressure import (  # noqa: E402
    build_pressure_spec, sigma_tables)
from pelvistim_fem_tpu_torch.ops import multigrid as tmg  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import measure  # noqa: E402
from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402
from pelvistim_fem_tpu_torch.ops.lattice_assembly import \
    assemble_lattice  # noqa: E402
from torch_threads import one_torch_thread  # noqa: E402,F401

F32, F64 = torch.float32, torch.float64


def _levels(fine, min_nodes=100, max_levels=8):
    """The grids of a hierarchy on `fine`, coarsened as
    lattice_assembly._hierarchy does (Transfer, until a level has at most
    min_nodes points)."""
    axes = [np.arange(n, dtype=float) for n in fine]
    shapes = [tuple(fine)]
    while len(shapes) < max_levels and np.prod(shapes[-1]) > min_nodes:
        tr = tmg.Transfer(axes)
        shapes.append(tr.nc)
        axes = tr.coarse_axes
    return shapes


# fine grid, the tail's first level in f32 and in f64: the step04 app's
# lattice, the megatet's, step02's padded group and a hierarchy that fits
# whole
HIERARCHIES = {"step04": ((55, 31, 19), 2, 3),
               "megatet": ((112, 68, 41), 3, 4),
               "step02": ((67, 29, 8), 2, 2),
               "fits whole": ((9, 7, 5), 0, 0)}


@pytest.mark.parametrize("name", list(HIERARCHIES))
def test_tail_start(name):
    """The first level from which every coarser level fits one block's
    shared memory: the tail from there fits, one level more does not."""
    fine, t32, t64 = HIERARCHIES[name]
    shapes = _levels(fine)
    for dt, t in ((F32, t32), (F64, t64)):
        assert tmg.tail_start(shapes, dt) == t
        assert sk.vcycle_tail_smem(shapes[t:], dt) <= sk.SMEM_MAX
        if t:
            assert sk.vcycle_tail_smem(shapes[t - 1:], dt) > sk.SMEM_MAX
    assert tmg.tail_start([(20, 20, 20)], F32) == 1      # nothing fits


def test_vcycle_tail_smem():
    """Per point of every level 27 planes, x, b and omega * dinv in the
    dtype and a 4-byte word; four arrays of the top level's points; 16
    reduction partials."""
    step04 = [(15, 9, 6), (8, 5, 4), (5, 3, 3)]
    assert sk.vcycle_tail_smem(step04, F32) == \
        4 * (30 * 1015 + 4 * 810 + 16) + 4 * 1015 == 138_884
    assert sk.vcycle_tail_smem(step04[1:], F64) == \
        8 * (30 * 205 + 4 * 160 + 16) + 4 * 205 == 55_268
    assert sk.vcycle_tail_smem([(15, 10, 6), (8, 6, 4), (5, 4, 3)],
                               F32) == 157_312
    assert sk.vcycle_tail_smem([(18, 8, 3), (10, 5, 2)], F32) == 72_944
    assert sk.vcycle_tail_smem([(28, 16, 10)] + step04, F32) == 753_124


@pytest.fixture(scope="module")
def coarse04():
    """The port's hierarchy of the coarse step04 lattice, (25, 14, 13) to
    (4, 3, 3), with two sigma tables."""
    spec, _ = build_pressure_spec(coarse=True)
    _, hier = assemble_lattice(spec, F64, device="cpu")
    tabs = torch.as_tensor(sigma_tables(spec, [5e-5, 0.5]))
    return hier, tabs


def _rhs(rng, free, dtype):
    return torch.where(free, torch.as_tensor(
        rng.standard_normal(tuple(free.shape)), dtype=dtype), 0.0)


@pytest.mark.parametrize("dtype", [F32, F64])
def test_plain_tail_equals_the_recursion(coarse04, dtype):
    """vcycle_tail_plain from every level t equals cycle_impl's
    level-by-level recursion from t, bit for bit."""
    hier, tabs = coarse04
    h = hier.astype(dtype)
    n = len(h.levels)
    ops = [tmg._level_op(lv, tabs[0].to(dtype)) for lv in h.levels]
    frees = [lv.free for lv in h.levels]
    rng = np.random.default_rng(31)
    for t in range(n - 1):
        b = _rhs(rng, frees[t], dtype)
        _, tail = tmg._v_tail([lv.C for lv in ops], frees, h.transfers, t)
        assert tail.shapes == tuple(tuple(f.shape) for f in frees[t:])
        want = tmg.cycle_impl(ops[t:], h.transfers[t:], b, tail_from=n - t)
        assert torch.equal(sk.vcycle_tail_plain(b, tail), want), t


def _stacked(h, per_lane_free):
    """Three lanes with their own stencils (the level's, 1.5 times it, the
    level's); masks one a lane (the third drops ~10% of the free points)
    or one shared by the lanes."""
    rng = np.random.default_rng(32)
    levels = []
    for lv in h.levels:
        free = lv.free[None]
        if per_lane_free:
            drop = torch.as_tensor(rng.random(tuple(lv.free.shape)) < 0.9)
            free = torch.stack([lv.free, lv.free, lv.free & drop])
        levels.append(tmg.MGLevel(
            coeff=torch.stack([lv.coeff, 1.5 * lv.coeff, lv.coeff]),
            free=free))
    return tmg.MGHierarchy(levels=tuple(levels), transfers=h.transfers)


@pytest.mark.parametrize("per_lane_free", [True, False])
def test_plain_tail_equals_the_lane_recursion(coarse04, per_lane_free):
    """With three lanes, each its own stencils, and a mask a lane or one
    shared: vcycle_tail_plain from every level t equals _fused_cycle's
    recursion from t bit for bit; a lane whose b is 0 stays 0 and
    finite."""
    hier, tabs = coarse04
    st = _stacked(hier.astype(F32), per_lane_free)
    n = len(st.levels)
    sig = tabs[[0, 1, 1]].float()
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, sig)
              for lv in st.levels]
    rng = np.random.default_rng(33)
    for t in range(n - 1):
        freeb = pieces[t][2]
        b = _rhs(rng, freeb.expand((3,) + tuple(freeb.shape[1:])), F32)
        b[1] = 0.0
        sub = tmg.MGHierarchy(levels=st.levels[t:],
                              transfers=st.transfers[t:])
        _, tail = tmg._fused_tail(pieces[t:], sub, 0, 2)
        got = sk.vcycle_tail_plain(b, tail)
        want = tmg._fused_cycle(pieces[t:], sub, b, tail_from=n - t)
        assert torch.equal(got, want), t
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got[1], torch.zeros_like(got[1]))
        assert float(got[0].abs().max()) > 0


def test_v_cycles_give_one_result_from_every_tail_level(coarse04):
    """make_v_cycle and the per-lane _fused_cycle with tail_from = 0 ..
    len(levels) give the same z (the CPU runs the tail's plain twin)."""
    hier, tabs = coarse04
    h = hier.astype(F32)
    n = len(h.levels)
    rng = np.random.default_rng(34)
    b = _rhs(rng, h.levels[0].free, F32)
    want = tmg.make_v_cycle(h, tabs[0].float())(b)
    for t in range(n + 1):
        assert torch.equal(tmg.make_v_cycle(h, tabs[0].float(),
                                            tail_from=t)(b), want), t
    st = _stacked(h, True)
    pieces = [tmg._fused_level_pieces(lv.coeff, lv.free, tabs[[0, 1, 1]]
                                      .float()) for lv in st.levels]
    B = _rhs(rng, st.levels[0].free, F32)
    want = tmg._fused_cycle(pieces, st, B)
    for t in range(n + 1):
        assert torch.equal(tmg._fused_cycle(pieces, st, B, tail_from=t),
                           want), t


def test_v_cycle_through_the_tail_matches_reference_f64():
    """One V-cycle of the JAX-assembled coarse step04 hierarchy, f64,
    through the tail from tail_start's level and from level 0, against
    the JAX package's make_v_cycle (tests/test_torch_multigrid.py's
    tolerance)."""
    jspec, _ = jax_pressure_spec(coarse=True)
    jcase, jhier = jla.assemble_lattice(jspec, jnp.float64)
    ihier = interop.hierarchy_from_numpy(
        [(np.asarray(lv.coeff), np.asarray(lv.free)) for lv in jhier.levels],
        jspec.axes, device="cpu")
    sig = np.array(jcase.sigma_table)
    free = np.asarray(jcase.free)
    b = np.where(free, np.random.default_rng(35).standard_normal(
        free.shape), 0.0)
    z_ref = np.asarray(jax.jit(lambda r: jmg.make_v_cycle(
        jhier, jnp.asarray(sig))(r))(jnp.asarray(b)))
    t = tmg.tail_start([tuple(lv.free.shape) for lv in ihier.levels], F64)
    assert t == 2
    for tail_from in (t, 0):
        z = tmg.make_v_cycle(ihier, torch.as_tensor(sig),
                             tail_from=tail_from)(torch.as_tensor(b))
        np.testing.assert_allclose(z.numpy(), z_ref, rtol=0,
                                   atol=1e-10 * np.abs(z_ref).max())


def test_make_vcycle_tail_refuses_tables_that_do_not_join(coarse04):
    hier, tabs = coarse04
    ops = [tmg._level_op(lv, tabs[0]) for lv in hier.levels]
    Cs = [lv.C for lv in ops]
    frees = [lv.free for lv in hier.levels]
    pro, res = hier.transfers[1]._tensors(torch.device("cpu"), F64)
    with pytest.raises(ValueError, match="does not join"):
        sk.make_vcycle_tail(Cs[:2], frees[:2], [pro], [res])
    with pytest.raises(ValueError, match="transfers"):
        sk.make_vcycle_tail(Cs[:3], frees[:3], [pro], [res])


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper never runs the twin: a tail made from CPU
    tensors raises before any build."""
    args = measure.kernel_inputs("vcycle_tail_cuda",
                                 (2, 24, 1, [(9, 7, 5), (5, 4, 3)]), F32,
                                 "cpu", np.random.default_rng(36))
    assert args[1].packed is None
    with pytest.raises(ValueError, match="must lie on a CUDA device"):
        sk.vcycle_tail_cuda(*args)
    assert torch.equal(sk.vcycle_tail(*args), sk.vcycle_tail_plain(*args))


def test_work_and_bound():
    """Bytes: each level's 27 planes and free byte, b and x of the top
    level; operations: 2 nu applies and their sweeps a level, then the
    coarse CG's 65 a point and iteration plus 4."""
    shape = (2, 24, 1, [(15, 9, 6), (8, 5, 4), (5, 3, 3)])
    nbytes, ops = measure.work("vcycle_tail_cuda", shape, "float32")
    assert nbytes == 1015 * 27 * 4 + 2 * 810 * 4 + 1015
    assert ops == (810 + 160) * (54 * 4 + 3 * 3 + 2) + 45 * (65 * 24 + 4)
    nbytes8, _ = measure.work("vcycle_tail_cuda", (2, 24, 8) + shape[3:],
                              "float64")
    assert nbytes8 == 8 * (1015 * 27 * 8 + 2 * 810 * 8 + 1015)
    ms, by = measure.bound("vcycle_tail_cuda", shape, "float32")
    assert by == "bytes"
    assert ms == pytest.approx(nbytes / measure.HBM_BYTES_PER_S * 1e3)


def test_check_vcycle_tail_moves_every_stencil():
    """check_vcycle_tail passes the twin itself and fails a result one
    level's stencil away (the twin on a tail whose coarsest stencil is
    doubled)."""
    args = measure.kernel_inputs(
        "vcycle_tail_cuda", (2, 24, 3, [(9, 7, 5), (5, 4, 3), (3, 3, 2)]),
        F64, "cpu", np.random.default_rng(37))
    b, tail, nu, omega, iters = args
    assert measure.check_vcycle_tail("twin", sk.vcycle_tail_plain(*args),
                                     args) == 0.0
    off = dataclasses.replace(tail, Cs=tail.Cs[:-1] + (2 * tail.Cs[-1],))
    with pytest.raises(AssertionError, match="max abs err"):
        measure.check_vcycle_tail("off", sk.vcycle_tail_plain(
            b, off, nu, omega, iters), args)


def test_ptxas_names_of_the_tail():
    """ptxas's report names the tail kernel by its dtype."""
    ns = "_ZN43_GLOBAL__N__ba4f02ef_10_stencil_cu_495321af"
    tail = "18vcycle_tail_kernelI{}EEvPKT_S3_PKhPKiS3_PS1_NS_8TailMetaEiiS1_i"
    assert sk.demangle_kernel(ns + tail.format("f")) == \
        "vcycle_tail_kernel<float>"
    assert sk.demangle_kernel(ns + tail.format("d")) == \
        "vcycle_tail_kernel<double>"
