"""tpurt_torch — the PyTorch/CUDA port of tpurt for one NVIDIA Hopper GPU.

The JAX package ``tpurt`` stays the reference. This package keeps its layer
and module names so that each port module sits where its counterpart does:

  scene/    static scene flattening (numpy), BVH8 collapse upload
  bvh/      numpy copies of the binned-SAH builder and the BVH8 collapse
  kernels/  hand-written CUDA kernels (csrc/) with their plain PyTorch twins
  passes/   rays, shading, GTAO, tonemap as tensor code
  engine/   state conversion, the frame, and the Renderer API
  app/      the bench scene

It imports ``torch`` and never ``jax``. The host-side scene modules of tpurt
that load no JAX (``tpurt.scene.{camera,lights,model,procedural}`` and
``tpurt.native``) are used directly.
"""

__version__ = "0.1.0"
