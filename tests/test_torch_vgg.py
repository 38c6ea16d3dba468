"""PyTorch port: VGG-19 trunk and pooling against the JAX package.

The JAX trunk is NHWC and the port's NCHW, so features are transposed at
the boundary. Both run in float32 with the same ``random_params(0)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.models import vgg as JV
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch.models import vgg as TV
from style_transfer_tpu_torch.models.weights import params_from_jax
from style_transfer_tpu_torch.ops.pooling import pool2x2

torch.set_num_threads(2)

PARAMS = random_params(0)
TAPS = (1, 6, 11, 20, 22, 29)
# 40x56 keeps 2x3 pixels at layer 29 (four pools), the deepest tap.
H, W = 40, 56


@pytest.fixture(scope="module")
def tparams():
    return params_from_jax(PARAMS)


def _image(seed=0):
    return np.random.RandomState(seed).uniform(size=(1, H, W, 3)).astype(np.float32)


def _to_nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("pooling", ["max", "average", "l2"])
def test_taps_match_jax(pooling, tparams):
    img = _image()
    jf = JV.extract_features({k: jnp.asarray(v) for k, v in PARAMS.items()},
                             jnp.asarray(img), TAPS, pooling=pooling,
                             compute_dtype=None)
    with torch.no_grad():
        tf = TV.extract_features(tparams, _to_nchw(img), TAPS, pooling=pooling)
    np.testing.assert_array_equal(tf[TV.INPUT].numpy().transpose(0, 2, 3, 1), img)
    for layer in TAPS:
        j = np.asarray(jf[layer])
        t = tf[layer].numpy().transpose(0, 2, 3, 1)
        assert t.shape == j.shape == (1, *TV.feature_shape(layer, H, W))
        # 1e-4 of the tap's max: both sum 3x3xC FP32 products in their own
        # order through up to 13 convs (measured at most 1.2e-6, max pooling
        # at layer 20).
        err = np.abs(t - j).max() / np.abs(j).max()
        assert err < 1e-4, (layer, err)


def test_image_gradient_matches_jax(tparams):
    img = _image(1)
    layers = (11, 22)

    def jloss(x):
        f = JV.extract_features({k: jnp.asarray(v) for k, v in PARAMS.items()},
                                x, layers, pooling="max", compute_dtype=None)
        return sum(jnp.sum(f[l]) for l in layers)

    jg = np.asarray(jax.grad(jloss)(jnp.asarray(img)))
    x = _to_nchw(img).requires_grad_(True)
    f = TV.extract_features(tparams, x, layers, pooling="max")
    (tg,) = torch.autograd.grad(sum(f[l].sum() for l in layers), x)
    tg = tg.numpy().transpose(0, 2, 3, 1)
    # Same 1e-4-of-max ceiling as the forward taps (measured 3.1e-7).
    err = np.abs(tg - jg).max() / np.abs(jg).max()
    assert err < 1e-4, err


def test_l2_pool_zero_window_gradient_is_zero():
    x = torch.zeros(1, 2, 4, 4)
    x[0, 0, 2:, 2:] = torch.tensor([[1.0, -2.0], [0.5, 3.0]])
    x.requires_grad_(True)
    y = pool2x2(x, "l2")
    np.testing.assert_allclose(y[0, 0, 1, 1].item(), np.sqrt(1 + 4 + 0.25 + 9), rtol=1e-6)
    (g,) = torch.autograd.grad(y.sum(), x)
    assert torch.isfinite(g).all()
    assert (g[0, 1] == 0).all() and (g[0, 0, :2, :2] == 0).all()
    assert (g[0, 0, 2:, 2:] != 0).all()


def test_min_size_guard():
    with pytest.raises(ValueError, match="at least 16x16"):
        TV.extract_features(params_from_jax(PARAMS), torch.zeros(1, 3, 15, 40), (29,))
    assert TV.min_input_size((29,)) == JV.min_input_size((29,)) == 16


@pytest.mark.parametrize("pad", [1, 2])
def test_replicate_pad_equals_f_pad(pad):
    """The cat-built replicate pad (whose backward sums in a fixed order)
    gives F.pad's values exactly and its gradient to rounding."""
    import torch.nn.functional as F

    from style_transfer_tpu_torch.ops.pooling import replicate_pad2d

    x = torch.randn(2, 3, 5, 7, dtype=torch.float64, requires_grad=True)
    ours, ref = replicate_pad2d(x, pad), F.pad(x, (pad,) * 4, mode="replicate")
    assert torch.equal(ours, ref)
    g = torch.randn_like(ref)
    (a,) = torch.autograd.grad(ours, x, g)
    (b,) = torch.autograd.grad(ref, x, g)
    torch.testing.assert_close(a, b, rtol=1e-12, atol=1e-12)


def _pin_nchw(monkeypatch):
    """Pins the trunk's layout rule to NCHW, the layout every trunk ran
    before the bf16 trunk went channels_last."""
    monkeypatch.setattr(TV, "trunk_memory_format",
                        lambda dtype, mesh=None: torch.contiguous_format)


@pytest.mark.parametrize("pooling", ["max", "average", "l2"])
def test_bf16_trunk_runs_channels_last(pooling, tparams, monkeypatch):
    """The bf16 trunk's kernels and taps are channels_last and its taps
    equal the NCHW bf16 trunk's within a bf16 rounding of the tap's max
    (measured: bit-identical on this CPU); the FP32 trunk's stay NCHW."""
    img = _to_nchw(_image(3))
    params = TV.cast_params(tparams, torch.bfloat16)
    assert params["conv2_kernel"].is_contiguous(memory_format=torch.channels_last)
    assert params["conv2_bias"].dtype == torch.bfloat16
    with torch.no_grad():
        f32 = TV.extract_features(tparams, img, TAPS, pooling=pooling)
        cl = TV.extract_features(params, img, TAPS, pooling=pooling,
                                 compute_dtype=torch.bfloat16)
        _pin_nchw(monkeypatch)
        nchw = TV.extract_features(params, img, TAPS, pooling=pooling,
                                   compute_dtype=torch.bfloat16)
    assert cl[TV.INPUT] is img
    for layer in TAPS:
        assert cl[layer].is_contiguous(memory_format=torch.channels_last)
        assert not cl[layer].is_contiguous()
        assert nchw[layer].is_contiguous() and f32[layer].is_contiguous()
        a, b = cl[layer].float().numpy(), nchw[layer].float().numpy()
        assert np.abs(a - b).max() <= 2**-8 * np.abs(b).max(), layer


@pytest.mark.parametrize("fmt", [torch.contiguous_format, torch.channels_last],
                         ids=["nchw", "channels_last"])
def test_max_pool_ties_go_to_the_first_maximum(fmt):
    """On integer-valued input, with ties in most windows, the gradient of
    each window goes to its first maximum in row-major order in either
    layout (odd sizes: the last row and column are floored away)."""
    x = np.random.RandomState(5).randint(0, 3, size=(1, 4, 9, 11)).astype(np.float32)
    g = np.arange(1, 1 + 4 * 4 * 5, dtype=np.float32).reshape(1, 4, 4, 5)
    want = np.zeros_like(x)
    for c in range(4):
        for i in range(4):
            for j in range(5):
                k = int(np.argmax(x[0, c, 2 * i:2 * i + 2, 2 * j:2 * j + 2]))  # first max
                want[0, c, 2 * i + k // 2, 2 * j + k % 2] = g[0, c, i, j]
    xt = torch.from_numpy(x).contiguous(memory_format=fmt).requires_grad_(True)
    y = pool2x2(xt, "max")
    assert y.is_contiguous(memory_format=fmt)
    (got,) = torch.autograd.grad(y, xt, torch.from_numpy(g).contiguous(memory_format=fmt))
    np.testing.assert_array_equal(got.numpy(), want)


def test_first_conv_of_a_channels_last_trunk_matches_conv2d():
    """conv1_1 of a channels_last trunk (NCHW in, channels_last out, the
    data gradient by the channels_last kernel, handed back NCHW) against
    ``F.conv2d``'s value and gradient, in float64."""
    import torch.nn.functional as F

    rng = np.random.RandomState(6)
    x0 = torch.from_numpy(rng.normal(size=(1, 3, 10, 12)))
    k = torch.from_numpy(rng.normal(size=(8, 3, 3, 3)))
    b = torch.from_numpy(rng.normal(size=(8,)))
    g = torch.from_numpy(rng.normal(size=(1, 8, 8, 10)))
    x, ref_x = x0.clone().requires_grad_(True), x0.clone().requires_grad_(True)
    y = TV._FirstConv.apply(x, k.contiguous(memory_format=torch.channels_last), b)
    ref = F.conv2d(ref_x, k, b)
    assert y.is_contiguous(memory_format=torch.channels_last) and not y.is_contiguous()
    torch.testing.assert_close(y, ref, rtol=1e-12, atol=1e-12)
    (gx,) = torch.autograd.grad(y, x, g.contiguous(memory_format=torch.channels_last))
    (ref_gx,) = torch.autograd.grad(ref, ref_x, g)
    assert gx.is_contiguous()
    torch.testing.assert_close(gx, ref_gx, rtol=1e-12, atol=1e-12)


def test_first_conv_of_a_channels_last_trunk_refuses_weight_gradients():
    """conv1_1 of a channels_last trunk gives the image's gradient only: a
    backward that asks for the kernel's gradient raises rather than
    handing back None."""
    x = torch.zeros(1, 3, 6, 6, dtype=torch.float64, requires_grad=True)
    k = torch.ones(4, 3, 3, 3, dtype=torch.float64, requires_grad=True)
    y = TV._FirstConv.apply(x, k, torch.zeros(4, dtype=torch.float64))
    with pytest.raises(NotImplementedError, match="image's gradient only"):
        torch.autograd.grad(y.sum(), (x, k))
