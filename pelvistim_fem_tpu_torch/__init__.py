"""pelvistim_fem_tpu_torch — PyTorch + CUDA port of pelvistim_fem_tpu.

The certified step04 contact sweep with its metric rows, the megatet
step03 solve, and the Jacobi stencil solvers, on the structured 27-point
stencil, for NVIDIA Hopper:

  mesh/, models/, utils/   numpy host front end: graded lattice recipes,
                           the compact LatticeSpec, the element TetMesh
                           (bit-identical twins of the JAX package's, JSON
                           parameters) and the element Case (models/case)
  ops/lattice_assembly     device assembly of per-body stencils and the
                           Galerkin-probed multigrid hierarchy
  ops/multigrid, ops/solve certified mixed-precision MG-CG (f32 inner,
                           f64 true residual); CG and Jacobi-PCG
  ops/stencil              the stencil operator and its Jacobi solvers
                           (single case, lane-major and lane-minor sweeps)
  ops/assembly, ops/bc,    element geometry, deterministic element -> node
  ops/fields, ops/metrics  sums, fields and the batched metric rows
  ops/kernels              hand-written CUDA stencil kernels (sm_90a)
                           and their plain PyTorch twins
  interop                  numpy hand-over of a case and hierarchy

This package imports torch and numpy only.  Every entry point that
builds tensors takes `device=`, default "cuda" (pelvistim_fem_tpu_torch
.device), and raises where there is no card; entry points that take
tensors follow their device.
"""

__version__ = "0.2.0"
