"""Image fidelity metrics: PSNR, SSIM, LPIPS, and VGG feature distance.

Port of ``style_transfer_tpu/utils/metrics.py``. PSNR and SSIM are numpy,
copied. ``vgg_distance`` runs the port's VGG-19 trunk on an explicit device
(``cuda:0`` by default) in FP32 and reduces in float64, as the JAX
function. LPIPS proper needs learned weights: when a local bundle resolves
(see ``utils/lpips.py``), :func:`perceptual_distance` computes the real
metric; otherwise it falls back to ``vgg_distance`` (unit-normalized VGG
feature differences averaged over layers, the standard offline proxy) and
says so. All functions take HWC float arrays in [0, 1].
"""

import numpy as np
import torch

__all__ = ["psnr", "ssim", "vgg_distance", "perceptual_distance"]


def _check(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {a.shape} vs {b.shape}")
    return a, b


def psnr(a, b, data_range: float = 1.0) -> float:
    a, b = _check(a, b)
    mse = np.mean((a - b) ** 2)
    if mse == 0:
        return float("inf")
    return float(10.0 * np.log10(data_range ** 2 / mse))


def _gaussian_kernel(size=11, sigma=1.5):
    ax = np.arange(size) - size // 2
    k = np.exp(-(ax ** 2) / (2 * sigma ** 2))
    k /= k.sum()
    return k


def _filter2d_sep(img, k):
    """Separable 2D filter along H and W of an HWC array ('valid' crop)."""
    pad = len(k) // 2
    out = img
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 0, out)
    out = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"), 1, out)
    return out[pad:-pad, pad:-pad]


def ssim(a, b, data_range: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004), 11x11 Gaussian window, per channel."""
    a, b = _check(a, b)
    if a.ndim == 2:
        a, b = a[..., None], b[..., None]
    k = _gaussian_kernel()
    c1 = (0.01 * data_range) ** 2
    c2 = (0.03 * data_range) ** 2
    vals = []
    for c in range(a.shape[2]):
        x, y = a[..., c], b[..., c]
        mx = _filter2d_sep(x, k)
        my = _filter2d_sep(y, k)
        mxx = _filter2d_sep(x * x, k)
        myy = _filter2d_sep(y * y, k)
        mxy = _filter2d_sep(x * y, k)
        vx = mxx - mx ** 2
        vy = myy - my ** 2
        cov = mxy - mx * my
        s = ((2 * mx * my + c1) * (2 * cov + c2)) / (
            (mx ** 2 + my ** 2 + c1) * (vx + vy + c2)
        )
        vals.append(s.mean())
    return float(np.mean(vals))


def unit_normalized_sq_diff(x, y, eps=1e-10):
    """Per-pixel squared difference of two NCHW feature maps, each divided
    by its channel norm plus ``eps``, in float64 (LPIPS's
    ``normalize_tensor``)."""
    x, y = x.double(), y.double()
    xn = x / (torch.sqrt((x * x).sum(1, keepdim=True)) + eps)
    yn = y / (torch.sqrt((y * y).sum(1, keepdim=True)) + eps)
    return (xn - yn) ** 2


def vgg_distance(a, b, params=None, layers=(1, 6, 11, 20, 29), device="cuda:0") -> float:
    """LPIPS-style perceptual distance: mean squared difference of channel-
    unit-normalized VGG features, averaged over layers (uniform weights).

    ``params`` are the port's OIHW tensors (``StyleTransfer.params``,
    ``weights.params_from_jax``); None resolves them as the engine does.
    The trunk runs on ``device`` in FP32."""
    from ..models.vgg import extract_features, fp32_math
    from ..models.weights import params_from_jax, resolve_params

    device = torch.device(device)
    if params is None:
        params = params_from_jax(resolve_params(None)[0], device)
    params = {k: v.to(device) for k, v in params.items()}
    a, b = _check(a, b)

    def feats(img):
        x = torch.from_numpy(img.astype(np.float32)).permute(2, 0, 1)[None]
        return extract_features(params, x.to(device), layers)

    with fp32_math(device), torch.no_grad():
        fa, fb = feats(a), feats(b)
        total = sum(unit_normalized_sq_diff(fa[l], fb[l]).mean().item()
                    for l in layers)
    return float(total / len(layers))


def perceptual_distance(a, b, params=None, lpips_weights=None, device="cuda:0"):
    """(value, kind): real LPIPS when a weight bundle resolves (explicit
    path > $STT_LPIPS_WEIGHTS > default locations, ``utils/lpips.py``), else
    the uniform-weight VGG-distance proxy. ``kind`` is ``"lpips-<net>"`` or
    ``"vgg_distance_proxy"`` so reports never pass a proxy off as LPIPS."""
    from . import lpips as lpips_mod

    bundle_path = lpips_mod.find_bundle(lpips_weights)
    if bundle_path is not None:
        bundle = lpips_mod.load_bundle(bundle_path)
        return lpips_mod.lpips(a, b, bundle, device=device), f"lpips-{bundle['net']}"
    return vgg_distance(a, b, params=params, device=device), "vgg_distance_proxy"
