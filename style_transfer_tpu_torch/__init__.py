"""style_transfer_tpu_torch: the PyTorch/CUDA port of style_transfer_tpu.

Optimization-based neural style transfer (W2/Gram style losses over frozen
VGG-19 features, the sqrt(2) Adam pyramid) in PyTorch, with the coupled
Newton-Schulz matrix square root as a hand-written CUDA kernel for Hopper
(``ops/cuda/ns_sqrtm.py``). Module paths mirror ``style_transfer_tpu`` so
each counterpart sits at the same place; this package never imports jax or
``style_transfer_tpu``.

Tensors are NCHW inside the package. The public surface keeps the JAX
package's layouts: PIL images in and out, ``(H, W, 3)`` float arrays from
``StyleTransfer.get_image_tensor``, ``STIterate`` callbacks, and HWIO
``.npz`` parameter files.
"""

from pathlib import Path

srgb_profile = (Path(__file__).resolve().parent / "srgb.icc").read_bytes()

from .engine import StyleTransfer  # noqa: E402
from .utils.trace import STIterate, TraceRecorder  # noqa: E402

__version__ = "0.1.0"
__all__ = ["StyleTransfer", "STIterate", "TraceRecorder", "srgb_profile"]
