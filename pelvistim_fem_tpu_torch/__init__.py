"""pelvistim_fem_tpu_torch — PyTorch + CUDA port of pelvistim_fem_tpu.

The certified step04 contact sweep and the megatet step03 solve on the
structured 27-point stencil, for NVIDIA Hopper:

  mesh/, models/, utils/   numpy host front end: graded lattice recipes
                           and the compact LatticeSpec (bit-identical
                           twins of the JAX package's, JSON parameters)
  ops/lattice_assembly     device assembly of per-body stencils and the
                           Galerkin-probed multigrid hierarchy
  ops/multigrid, ops/solve certified mixed-precision MG-CG (f32 inner,
                           f64 true residual)
  ops/stencil              the stencil operator
  ops/kernels              hand-written CUDA stencil kernels (sm_90a)
                           and their plain PyTorch twins
  interop                  numpy hand-over of a case and hierarchy

This package imports torch and numpy only.  Every entry point follows
the device of its input tensors or takes `device=`.
"""

__version__ = "0.1.0"
