"""mst_torch — the PyTorch/CUDA port of mst_tpu for NVIDIA Hopper (H100).

The JAX package ``mst_tpu`` stays the reference; this package mirrors its
module names so each piece has an obvious counterpart:

- ``mst_torch.io``, ``mst_torch.theory``, ``mst_torch.data``,
  ``mst_torch.ops.{events,quantize,rasterize}`` — host code (numpy), copies
  of their mst_tpu counterparts with imports rewritten.
- ``mst_torch.ops.device_raster`` — on-device rasterization of note records
  through the hand-written CUDA scatter-max kernel (``csrc/raster.cu``).
- ``mst_torch.ops.grid_kernel`` — the pitched applier's note-grid tail as a
  hand-written CUDA kernel (``csrc/grid_tail.cu``).
- ``mst_torch.models`` — the nine modules of the style-transfer model as
  ``nn.Module``s; ``mst_torch.weights`` maps flax parameter trees onto them.
- ``mst_torch.transfer`` — batched style transfer, MIDI in, ``.mid`` out.

Importing this package imports torch and numpy only: never jax, flax, orbax
or anything under ``mst_tpu``.
"""

__version__ = "0.1.0"
