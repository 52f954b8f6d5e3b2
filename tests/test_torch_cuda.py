"""PyTorch port on a CUDA card: the stencil kernels against their plain
twins, and a small certified sweep on the card against the CPU.

Marked `cuda`; every test skips where no CUDA device is present.  On a
machine with a card (and without JAX, which tests/conftest.py imports):

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from pelvistim_fem_tpu_torch.ops.kernels import \
    stencil_kernels as sk  # noqa: E402

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


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("L,B,shape", [(3, 5, (8, 7, 6)), (5, 2, (14, 9, 8)),
                                       (40, 3, (9, 7, 6)), (1, 8, (5, 4, 3))])
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
