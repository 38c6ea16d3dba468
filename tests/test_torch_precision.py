"""PyTorch port: ``--precision`` (the bf16 VGG trunk) against the JAX
package's bf16 trunk and against FP32, on the CPU.

In bf16 the activations are cast after ``normalize`` and the conv weights
once per engine; the losses upcast every tap to FP32. Tolerances, each over
the max of the reference (measured on this CPU beside each):
- port bf16 against JAX bf16, per tap: 2e-2 (measured <= 1.1e-2): both
  round each conv's output to bf16, at slightly different points (JAX adds
  the bias after one rounding);
- port bf16 against port FP32, per tap: 5e-2, the JAX package's own bound
  (``tests/test_vgg.py``; measured <= 1.2e-2);
- the image gradient, bf16 against FP32 trunk: 1e-1 in relative L2 norm
  (measured 3.2e-2; its max-element error reaches 4.9e-2 of the max);
- the 64 px engine run, bf16 port against bf16 JAX: losses to rtol 1e-2
  (measured 7.4e-4), the final image above 30 dB PSNR (measured 36.7 dB;
  the FP32 pair reaches 64.7 dB, test_torch_engine.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu.models import vgg as JV
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch.engine import _resolve_compute_dtype
from style_transfer_tpu_torch.models import vgg as TV
from style_transfer_tpu_torch.models.weights import params_from_jax
from style_transfer_tpu_torch.step import StepConfig, build_loss_fn

torch.set_num_threads(2)

PARAMS = random_params(0)
TAPS = (1, 6, 11, 20, 22, 29)
H, W = 40, 56


def _image(seed=0):
    return np.random.RandomState(seed).uniform(size=(1, H, W, 3)).astype(np.float32)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel(a, ref):
    return float(np.abs(a - ref).max() / np.abs(ref).max())


@pytest.mark.parametrize("pooling", ["max", "average", "l2"])
def test_bf16_taps_match_jax_bf16(pooling):
    img = _image()
    jf = JV.extract_features({k: jnp.asarray(v) for k, v in PARAMS.items()},
                             jnp.asarray(img), TAPS, pooling=pooling,
                             compute_dtype=jnp.bfloat16)
    params = TV.cast_params(params_from_jax(PARAMS), torch.bfloat16)
    with torch.no_grad():
        tf = TV.extract_features(params, _nchw(img), TAPS, pooling=pooling,
                                 compute_dtype=torch.bfloat16)
    assert tf[TV.INPUT].dtype == torch.float32  # TV reads the FP32 image
    for layer in TAPS:
        assert tf[layer].dtype == torch.bfloat16
        j = np.asarray(jf[layer], np.float32)
        t = tf[layer].float().numpy().transpose(0, 2, 3, 1)
        assert _rel(t, j) < 2e-2, (layer, _rel(t, j))


def test_bf16_taps_close_to_f32():
    img = _nchw(_image(1))
    f32 = params_from_jax(PARAMS)
    with torch.no_grad():
        a = TV.extract_features(f32, img, TAPS)
        b = TV.extract_features(TV.cast_params(f32, torch.bfloat16), img, TAPS,
                                compute_dtype=torch.bfloat16)
    for layer in TAPS:
        assert _rel(b[layer].float().numpy(), a[layer].numpy()) < 5e-2, layer


def test_bf16_loss_and_gradient_are_fp32():
    """The image, its gradient and the loss stay FP32 under a bf16 trunk,
    and the gradient is near the FP32 one in relative L2 norm."""
    from style_transfer_tpu_torch.ops import losses as L

    img = _nchw(_image(2))
    f32 = params_from_jax(PARAMS)
    style = TV.extract_features(f32, _nchw(_image(3)), (1, 6, 11, 20, 29))
    consts = {"content": {22: TV.extract_features(f32, img, (22,))[22]},
              "style": {l: L.w2_target(*L.w2_moments(style[l]))
                        for l in (1, 6, 11, 20, 29)}}
    grads = {}
    for dtype, params in ((None, f32), (torch.bfloat16, TV.cast_params(f32, torch.bfloat16))):
        x = (img * 0.9 + 0.05).requires_grad_(True)
        loss = build_loss_fn(StepConfig(compute_dtype=dtype))(x, params, consts)
        assert loss.dtype == torch.float32
        (grads[dtype],) = torch.autograd.grad(loss, x)
        assert grads[dtype].dtype == torch.float32
    g32, g16 = grads[None].numpy(), grads[torch.bfloat16].numpy()
    rel_l2 = float(np.linalg.norm(g16 - g32) / np.linalg.norm(g32))
    assert rel_l2 < 1e-1, rel_l2


def test_engine_bf16_matches_jax_bf16(content_pil, style_pil):
    kw = dict(min_scale=64, end_scale=64, iterations=10, initial_iterations=10)
    jst = J.StyleTransfer(devices=1, weights=PARAMS, compute_dtype="bfloat16",
                          sqrtm_impl="xla", w2_grad="trace", callback_chunk=10)
    tst = T.StyleTransfer(device="cpu", weights=PARAMS, compute_dtype="bf16",
                          callback_chunk=10)
    j_its, t_its = [], []
    jst.stylize(content_pil, [style_pil], callback=j_its.append, **kw)
    tst.stylize(content_pil, [style_pil], callback=t_its.append, **kw)
    assert len(t_its) == len(j_its) == 10
    # The cast params are made once per engine and reused by every step.
    assert tst._step_params() is tst._step_params()
    assert tst._step_params()["conv0_kernel"].dtype == torch.bfloat16
    assert tst.params["conv0_kernel"].dtype == torch.float32
    np.testing.assert_allclose([i.loss for i in t_its], [i.loss for i in j_its],
                               rtol=1e-2)
    t_img, j_img = tst.get_image_tensor(), jst.get_image_tensor()
    assert t_img.dtype == np.float32
    psnr = 10 * np.log10(1.0 / max(float(np.mean((t_img - j_img) ** 2)), 1e-12))
    assert psnr > 30.0, psnr


@pytest.mark.parametrize("name,expect", [
    ("auto", None), ("f32", None), ("float32", None), (None, None),
    ("bf16", torch.bfloat16), ("bfloat16", torch.bfloat16)])
def test_precision_resolves(name, expect):
    """'auto' is FP32 on every device of the port (the JAX package picks
    bf16 only on a TPU), so the default path keeps its numbers."""
    assert _resolve_compute_dtype(name) is expect


def test_auto_engine_is_f32_on_cpu():
    st = T.StyleTransfer(device="cpu", weights=PARAMS)
    assert st.compute_dtype is None and st._step_params() is st.params
    with pytest.raises(ValueError, match="compute_dtype"):
        T.StyleTransfer(device="cpu", weights=PARAMS, compute_dtype="fp8")


def test_bf16_channels_last_gradient_matches_the_nchw_trunk(monkeypatch):
    """The bf16 trunk runs channels_last, and the image's gradient it gives
    is NCHW-contiguous FP32, as Adam's state is laid out, and near the NCHW
    bf16 trunk's: 1e-2 in relative L2 norm (measured 6.2e-4: the taps
    agree, the moments sum in another order and the gradients round to
    bf16 at other points), so a wrong layout path in a backward fails."""
    from style_transfer_tpu_torch.ops import losses as L

    img = _nchw(_image(2))
    f32 = params_from_jax(PARAMS)
    params = TV.cast_params(f32, torch.bfloat16)
    style = TV.extract_features(f32, _nchw(_image(3)), (1, 6, 11, 20, 29))
    targets = {l: L.w2_target(*L.w2_moments(style[l])) for l in (1, 6, 11, 20, 29)}
    cfg = StepConfig(compute_dtype=torch.bfloat16)
    grads = []
    for pin in (False, True):
        if pin:  # the NCHW trunk: the layout rule pinned to NCHW
            monkeypatch.setattr(TV, "trunk_memory_format",
                                lambda dtype, mesh=None: torch.contiguous_format)
        with torch.no_grad():
            content = TV.extract_features(params, img, (22,), compute_dtype=torch.bfloat16)[22]
        assert content.is_contiguous() is pin
        x = (img * 0.9 + 0.05).requires_grad_(True)
        loss = build_loss_fn(cfg)(x, params, {"content": {22: content}, "style": targets})
        (g,) = torch.autograd.grad(loss, x)
        assert g.dtype == torch.float32 and g.is_contiguous()
        grads.append(g.numpy())
    rel_l2 = float(np.linalg.norm(grads[0] - grads[1]) / np.linalg.norm(grads[1]))
    assert rel_l2 < 1e-2, rel_l2
