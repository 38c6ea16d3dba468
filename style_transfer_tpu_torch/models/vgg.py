"""VGG-19 feature extractor at reference semantics (NCHW in shape).

Port of ``style_transfer_tpu/models/vgg.py::extract_features`` without its
TPU layout variants: a plain function over an explicit parameter dict of
OIHW kernels (see ``weights.params_from_jax``). The trunk runs in FP32 or,
with ``compute_dtype=torch.bfloat16``, in bf16 from the first conv on (the
cast comes after ``normalize``, as the JAX trunk's off a TPU); the losses
upcast every tap to FP32.

The memory format of the activations follows from the trunk's dtype and
mesh (``trunk_memory_format``): a bf16 trunk on one device runs
channels_last (NHWC in memory), the layout of cuDNN's bf16 tensor-core
kernels, from conv1_1's output to every tap, with its kernels cast
channels_last once (``cast_params``); conv1_1's forward itself stays on the
NCHW input (:class:`_FirstConv`), so the taps equal the NCHW trunk's bit
for bit. An FP32 or sharded trunk runs NCHW. The image's gradient comes
back NCHW-contiguous in FP32 either way. Each call records the format it
ran as the recorder's ``trunk-layout`` counter (``utils/trace.py``).

* layer numbering = torchvision ``features`` indices (default taps
  [1,6,11,20,29] style / [22] content);
* ImageNet normalization of sRGB [0,1] inputs;
* conv1_1 replicate-padded, the other convs zero-padded;
* max/average/L2 pooling with activation rescale {1, 2, 0.78};
* the raw input rides along as ``feats[INPUT]`` (key -1) for the TV loss;
* minimum-input-size guard of 2^(#pools <= last tapped layer);
* with a ``mesh`` (``parallel/mesh.py``, placed on the canvas) the input is
  this rank's slab, and each conv pads it through ``halo_pad``: the
  neighbours' rows and columns inside, the pad above at the global border;
* with ``remat`` the trunk runs in segments under
  ``torch.utils.checkpoint``, the port of the JAX step's ``jax.checkpoint``
  around the trunk: one wrapping of the whole trunk would recompute every
  activation at once in the backward and keep most of the peak, so the
  segments end at the pools and the taps.

Tensors here are NCHW in shape; the JAX package's are NHWC, so tests
comparing the two transpose at the boundary.
"""

import contextlib
import functools
from typing import Sequence

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.pooling import POOLING_SCALES, pool2x2, replicate_pad2d
from ..parallel.mesh import halo_pad
from ..utils.trace import counter
from .weights import CONV_CHANNELS, CONV_INDICES, POOL_INDICES

__all__ = [
    "INPUT",
    "IMAGENET_MEAN",
    "IMAGENET_STD",
    "min_input_size",
    "feature_shape",
    "normalize",
    "cast_params",
    "trunk_memory_format",
    "extract_features",
    "fp32_math",
    "remat_segment_ends",
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


def trunk_memory_format(dtype, mesh=None):
    """The memory format of the trunk's activations and kernels:
    channels_last for a bf16 trunk on one device, whose cuDNN kernels are
    NHWC kernels (an NCHW tensor would be transposed on the way in and out
    of every convolution); NCHW otherwise, for the FP32 kernels cuDNN picks
    (FFT, ``dgrad_engine``), which are NCHW kernels, and under a ``mesh``,
    whose halo exchange works on NCHW slabs."""
    if dtype == torch.bfloat16 and mesh is None:
        return torch.channels_last
    return torch.contiguous_format


def cast_params(params, dtype, mesh=None):
    """The conv weights in ``dtype`` and the trunk's memory format
    (``trunk_memory_format``): one copy, made once per engine and dtype, so
    the step casts and transposes nothing."""
    fmt = trunk_memory_format(dtype, mesh)
    return {k: v.to(dtype, memory_format=fmt) if v.ndim == 4 else v.to(dtype)
            for k, v in params.items()}


class _FirstConv(torch.autograd.Function):
    """conv1_1 of a channels_last trunk, on its replicate-padded NCHW
    3-channel input. The forward runs the NCHW kernel, cuDNN's direct
    kernel that the NCHW trunk runs (an NHWC kernel pads the input to 8
    channels and rounds the output otherwise, which every later tap would
    carry), and hands on a channels_last output: the trunk's one
    transposition. The backward takes the data gradient from the
    channels_last output gradient with the channels_last kernel, as every
    later layer does, and hands the input an NCHW gradient."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.save_for_backward(kernel)
        ctx.shape = x.shape
        y = F.conv2d(x, kernel.contiguous(), bias)
        # To channels_last as a product with the identity: exact (each
        # element is itself times 1 plus products by 0, summed in FP32),
        # and cuBLAS reads the NCHW tensor in tiles, where ATen's copy
        # reads it with a stride of H*W (0.57 against 1.80 ms a step at
        # 2896x2172 on the H100).
        n, c, h, w = y.shape
        eye = torch.eye(c, dtype=y.dtype, device=y.device)
        y = torch.matmul(y.view(n, c, h * w).transpose(1, 2), eye)
        return y.view(n, h, w, c).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, g):
        if any(ctx.needs_input_grad[1:]):
            raise NotImplementedError(
                "conv1_1 of a channels_last trunk gives the image's gradient only, "
                "not the kernel's or the bias's")
        (kernel,) = ctx.saved_tensors
        # The input is never read; the cuDNN backward converts the gradient
        # to the input's memory format, so it is channels_last (an expanded
        # one, ``torch.nn.grad.conv2d_input``'s, would cost two
        # transpositions of the gradient).
        x = torch.empty(ctx.shape, dtype=g.dtype, device=g.device,
                        memory_format=torch.channels_last)
        gx = torch.ops.aten.convolution_backward(
            g, x, kernel, None, (1, 1), (0, 0), (1, 1), False, (0, 0), 1,
            (True, False, False))[0]
        return gx.contiguous(), None, None


def remat_segment_ends(layers: Sequence[int]):
    """The sorted layer indices after which the rematerialised trunk ends a
    segment, for the taps ``layers``: after every pool and every tap, so
    that the backward keeps the taps and the pools' outputs and recomputes
    at most one conv block between two of them. (Segments at the taps only,
    one per conv unit, and one around the whole trunk, the JAX package's
    wrapping, each peaked higher on the card: PERF.md §6.)"""
    layers = sorted(set(int(l) for l in layers))
    return sorted({i for i in POOL_INDICES if i < layers[-1]} | set(layers))


def _run_layers(params, x, first, end, wanted, pooling, mesh, fmt):
    """Layers ``first`` .. ``end`` of the trunk on ``x`` in memory format
    ``fmt``: returns the last activation and the tapped ones on the way, in
    layer order."""
    pool_scale = POOLING_SCALES[pooling]
    taps = []
    for i in range(first, end + 1):
        if i in _CONV_SET:
            # A no-op when the params are already in the trunk's dtype and
            # format (``cast_params``).
            kernel = params[f"conv{i}_kernel"].to(x.dtype, memory_format=fmt)
            bias = params[f"conv{i}_bias"].to(x.dtype)
            if mesh is not None:
                x = F.conv2d(halo_pad(x, mesh, replicate=i == 0), kernel, bias)
            elif i == 0:  # conv1_1: replicate padding (reference :38-39)
                x = replicate_pad2d(x, 1)
                x = (_FirstConv.apply(x, kernel, bias) if fmt == torch.channels_last
                     else F.conv2d(x, kernel, bias))
            else:
                x = F.conv2d(x, kernel, bias, padding=1)
        elif i in _POOL_SET:
            x = pool2x2(x, pooling)
            if pooling != "max":
                x = x * pool_scale
        else:
            x = F.relu(x)
        if i in wanted:
            taps.append(x)
    return (x, *taps)


def extract_features(params, image, layers: Sequence[int], pooling: str = "max",
                     compute_dtype=None, mesh=None, remat=False, at_tap=None):
    """Run the VGG-19 trunk up to the last requested layer.

    Args:
      params: dict of ``conv{i}_kernel`` (OIHW) / ``conv{i}_bias`` tensors;
        for a bf16 trunk pass them already cast (``cast_params``).
      image: NCHW float image in [0, 1] (sRGB), contiguous.
      layers: torchvision feature indices to tap (sorted set semantics).
      pooling: 'max' | 'average' | 'l2'.
      compute_dtype: dtype of the trunk (``torch.bfloat16``), or None for
        the image's own (FP32).
      mesh: the mesh placed on the whole image's canvas when ``image`` is
        this rank's slab of it, else None.
      remat: whether the trunk runs in segments
        (``remat_segment_ends``), each under ``torch.utils.checkpoint``,
        which keeps a segment's input and outputs for the backward and
        recomputes the rest inside it. The values and gradients are the
        same; the peak memory of a backward through the features is lower.
        Without remat the same segments run unwrapped.
        Under a mesh a segment's recompute re-runs its halo exchanges; the
        segments are the same on every rank.
      at_tap: None, or ``at_tap(layer, activation)``, called for each tap
        when the trunk has made it and before it goes on (outside any
        checkpoint). What a loss computes from a tap there comes before the
        deeper layers in autograd's graph, so the backward, which runs the
        later-made nodes first, computes the tap's gradient from that loss
        only after the deeper layers' backward: the gradient is not held
        through the rest of the backward.

    Returns:
      dict mapping ``INPUT`` (-1) -> the raw image and each tapped index ->
      its NCHW-shaped activation, in the trunk's dtype and memory format.
    """
    layers = sorted(set(int(l) for l in layers))
    h, w = image.shape[2:4] if mesh is None else mesh.canvas
    mins = min_input_size(layers)
    if min(h, w) < mins:
        raise ValueError(f"Input is {h}x{w} but must be at least {mins}x{mins}")
    feats = {INPUT: image}
    x = normalize(image)
    if compute_dtype is not None:
        x = x.to(compute_dtype)
    fmt = trunk_memory_format(x.dtype, mesh)
    counter("trunk-layout", "channels_last" if fmt == torch.channels_last else "nchw")
    wanted = set(layers)
    first = 0
    for end in remat_segment_ends(layers):
        run = functools.partial(_run_layers, params, first=first, end=end, wanted=wanted,
                                pooling=pooling, mesh=mesh, fmt=fmt)
        # The trunk draws no random numbers, and saving the RNG state
        # (preserve_rng_state) would read the CUDA generator, which a CUDA
        # graph's capture forbids.
        out = (checkpoint(run, x, use_reentrant=False, preserve_rng_state=False)
               if remat else run(x))
        x = out[0]
        for layer, tap in zip(sorted(l for l in wanted if first <= l <= end), out[1:]):
            feats[layer] = tap
            if at_tap is not None:
                at_tap(layer, tap)
        first = end + 1
    return feats
