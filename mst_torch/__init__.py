"""mst_torch — the PyTorch/CUDA port of mst_tpu for NVIDIA Hopper (H100).

The JAX package ``mst_tpu`` stays the reference; this package mirrors its
module names so each piece has an obvious counterpart:

- ``mst_torch.io``, ``mst_torch.theory``, ``mst_torch.data``,
  ``mst_torch.ops.{events,quantize,rasterize}`` — host code (numpy), copies
  of their mst_tpu counterparts with imports rewritten.
- ``mst_torch.ops.device_raster`` — on-device rasterization of note records
  through the hand-written CUDA scatter-max kernel (``csrc/raster.cu``).
- ``mst_torch.ops.grid_kernel`` — the pitched applier's note-grid tail,
  forward and backward, as hand-written CUDA kernels (``csrc/grid_tail.cu``,
  ``csrc/grid_tail_bwd.cu``) joined in the autograd function ``GridTail``.
- ``mst_torch.models`` — the nine modules of the style-transfer model as
  ``nn.Module``s; ``mst_torch.weights`` maps flax parameter trees (and
  whole train states) onto them.
- ``mst_torch.ops.losses`` and ``mst_torch.runtime`` — the training loss,
  step, checkpoints and logging (``train-model-torch.py``).
- ``mst_torch.transfer`` — batched style transfer, MIDI in, ``.mid`` out.

Importing this package imports torch and numpy only: never jax, flax,
optax, orbax, tqdm or anything under ``mst_tpu``.
"""

__version__ = "0.1.0"
