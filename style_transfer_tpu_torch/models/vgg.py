"""VGG-19 feature extractor at reference semantics (NCHW).

Port of ``style_transfer_tpu/models/vgg.py::extract_features`` without its
TPU layout variants: a plain function over an explicit parameter dict of
OIHW kernels (see ``weights.params_from_jax``). The trunk runs in FP32 or,
with ``compute_dtype=torch.bfloat16``, in bf16 from the first conv on (the
cast comes after ``normalize``, as the JAX trunk's off a TPU); the losses
upcast every tap to FP32.

* layer numbering = torchvision ``features`` indices (default taps
  [1,6,11,20,29] style / [22] content);
* ImageNet normalization of sRGB [0,1] inputs;
* conv1_1 replicate-padded, the other convs zero-padded;
* max/average/L2 pooling with activation rescale {1, 2, 0.78};
* the raw input rides along as ``feats[INPUT]`` (key -1) for the TV loss;
* minimum-input-size guard of 2^(#pools <= last tapped layer);
* with a ``mesh`` (``parallel/mesh.py``, placed on the canvas) the input is
  this rank's slab, and each conv pads it through ``halo_pad``: the
  neighbours' rows and columns inside, the pad above at the global border.

Tensors here are NCHW; the JAX package's are NHWC, so tests comparing the
two transpose at the boundary.
"""

import contextlib
import functools
from typing import Sequence

import torch
import torch.nn.functional as F

from ..ops.pooling import POOLING_SCALES, pool2x2, replicate_pad2d
from ..parallel.mesh import halo_pad
from .weights import CONV_CHANNELS, CONV_INDICES, POOL_INDICES

__all__ = [
    "INPUT",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "min_input_size",
    "feature_shape",
    "normalize",
    "cast_params",
    "extract_features",
    "fp32_math",
]

# Key for the raw (pre-normalization) input image in the feats dict.
INPUT = -1

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)

_CONV_SET = frozenset(CONV_INDICES)
_POOL_SET = frozenset(POOL_INDICES)


def min_input_size(layers: Sequence[int]) -> int:
    """2^(number of pooling layers at or before the last tapped layer)."""
    last = max(layers)
    size = 1
    for p in POOL_INDICES:
        if last < p:
            break
        size *= 2
    return size


def feature_shape(layer: int, h: int, w: int):
    """(h, w, c) of the activation tapped at ``layer`` for an h x w input
    (the JAX package's order) — pools floor-halve, convs preserve."""
    pools = sum(1 for p in POOL_INDICES if p <= layer)
    conv_idxs = [i for i in CONV_INDICES if i <= layer]
    c = CONV_CHANNELS[conv_idxs[-1]][1] if conv_idxs else 3
    for _ in range(pools):
        h, w = h // 2, w // 2
    return h, w, c


@contextlib.contextmanager
def fp32_math(device):
    """Full-FP32 matmuls and cuDNN convolutions on CUDA for the duration.

    TF32 (cuDNN's default for float32 convolutions) keeps about three
    decimal digits: the Newton-Schulz chain diverges under such single-pass
    products, and the trunk would leave parity with the FP32 reference."""
    if device.type != "cuda":
        yield
        return
    saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@functools.lru_cache(maxsize=None)
def _imagenet_stats(device, dtype):
    """(1, 3, 1, 1) mean and std, copied to ``device`` once: a host-to-device
    copy inside the step would synchronize the stream every iteration."""
    return tuple(torch.tensor(v, dtype=dtype).view(1, 3, 1, 1).to(device)
                 for v in (IMAGENET_MEAN, IMAGENET_STD))


def normalize(x):
    mean, std = _imagenet_stats(x.device, x.dtype)
    return (x - mean) / std


def cast_params(params, dtype):
    """The conv weights in ``dtype`` (one copy, made once per engine and
    dtype, so the step casts nothing)."""
    return {k: v.to(dtype) for k, v in params.items()}


def extract_features(params, image, layers: Sequence[int], pooling: str = "max",
                     compute_dtype=None, mesh=None):
    """Run the VGG-19 trunk up to the last requested layer.

    Args:
      params: dict of ``conv{i}_kernel`` (OIHW) / ``conv{i}_bias`` tensors;
        for a bf16 trunk pass them already cast (``cast_params``).
      image: NCHW float image in [0, 1] (sRGB).
      layers: torchvision feature indices to tap (sorted set semantics).
      pooling: 'max' | 'average' | 'l2'.
      compute_dtype: dtype of the trunk (``torch.bfloat16``), or None for
        the image's own (FP32).
      mesh: the mesh placed on the whole image's canvas when ``image`` is
        this rank's slab of it, else None.

    Returns:
      dict mapping ``INPUT`` (-1) -> the raw image and each tapped index ->
      its NCHW activation, in the trunk's dtype.
    """
    layers = sorted(set(int(l) for l in layers))
    last = layers[-1]
    h, w = image.shape[2:4] if mesh is None else mesh.canvas
    mins = min_input_size(layers)
    if min(h, w) < mins:
        raise ValueError(f"Input is {h}x{w} but must be at least {mins}x{mins}")
    pool_scale = POOLING_SCALES[pooling]
    feats = {INPUT: image}
    x = normalize(image)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    wanted = set(layers)
    for i in range(last + 1):
        if i in _CONV_SET:
            # A no-op when the params are already in the trunk's dtype.
            kernel = params[f"conv{i}_kernel"].to(x.dtype)
            bias = params[f"conv{i}_bias"].to(x.dtype)
            if mesh is not None:
                x = F.conv2d(halo_pad(x, mesh, replicate=i == 0), kernel, bias)
            elif i == 0:  # conv1_1: replicate padding (reference :38-39)
                x = F.conv2d(replicate_pad2d(x, 1), kernel, bias)
            else:
                x = F.conv2d(x, kernel, bias, padding=1)
        elif i in _POOL_SET:
            x = pool2x2(x, pooling)
            if pooling != "max":
                x = x * pool_scale
        else:
            x = F.relu(x)
        if i in wanted:
            feats[i] = x
    return feats
