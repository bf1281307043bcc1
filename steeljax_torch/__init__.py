"""steeljax_torch — the PyTorch/CUDA port of steeljax.

A second package beside `steeljax` (the JAX reference).  Module paths
mirror the reference (`steeljax_torch/render/pt/integrator.py` <->
`steeljax/render/pt/integrator.py`); plain tensor code is PyTorch and the
reference's Pallas traversal kernels are hand-written CUDA kernels
(`csrc/*.cu`, bound by `accel/cuda_traverse.py`).

Today the port runs the path tracer and the hybrid renderer on builtin
scenes and GLTF files (scene.loader) of any triangle count, cut into
chunks above dispatch.MAX_CHUNK_TRIS (lights, textures, alpha-tested
materials, instancing, treelets, 8- or 16-wide supernodes; cube, panorama
and procedural environments with their IBL bakes; the light-volume GI,
gi), splits the pixels of a frame or the rays of a probe capture across
devices (parallel), and validates the prepared tables when asked
(core.validate); anything else raises NotImplementedError naming the
ROADMAP item that brings it.

This package never imports jax or steeljax: the machine with the card has
neither.  Only the tests import both packages.
"""

__version__ = "0.1.0"

import torch as _torch

# fp32 everywhere, as in the reference (which forces full-precision
# matmuls): no TF32 in matrix products or convolutions.
_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
