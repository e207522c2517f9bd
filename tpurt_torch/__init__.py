"""tpurt_torch — the PyTorch/CUDA port of tpurt for one NVIDIA Hopper GPU.

The JAX package ``tpurt`` stays the reference. This package keeps its layer
and module names so that each port module sits where its counterpart does:

  scene/    numpy copies of tpurt's host scene modules (camera, lights,
            mesh, gltf, model, procedural) and the scene flattening
  bvh/      the binned-SAH builder, the BVH8 collapse and refit (numpy),
            and the LBVH built with tensor ops on the frame's device
  native/   the SAH builder's C++ (csrc/host), built with g++ on first use
  kernels/  hand-written CUDA kernels (csrc/) with their plain PyTorch twins
  passes/   rays, shading, GTAO, tonemap as tensor code
  engine/   state conversion, the static and dynamic frames, the Renderer
  app/      the bench scene and its animation

It imports ``torch`` and numpy, never ``jax`` and nothing of ``tpurt``:
the host modules it needs are its own copies.
"""

__version__ = "0.2.0"
