"""PyTorch port: the rematerialised VGG trunk (``--remat``) on the CPU.

The loss and gradient with the trunk rematerialised against the trunk
without, the per-term diagnostic against the loss, the engine with
``remat=True`` against the JAX engine with ``remat=True``, the
``remat=None`` rule as a pure function, and the CLI's ``--remat`` choices.
Inputs are made from seeded numpy draws; the port's NS wrapper takes its
plain version on CPU tensors.
"""

import json

import numpy as np
import pytest
import torch

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu.engine import auto_size_knobs
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch import cli as tcli
from style_transfer_tpu_torch.bench import build_step
from style_transfer_tpu_torch.engine import (REMAT_MEMORY_SHARE, auto_remat,
                                             predicted_peak_bytes)
from style_transfer_tpu_torch.models.vgg import remat_segment_ends
from style_transfer_tpu_torch.ops import losses as L
from style_transfer_tpu_torch.parallel.mesh import Mesh
from style_transfer_tpu_torch.step import (OPTIMIZERS, StepConfig, build_loss_fn,
                                           build_loss_terms_fn)

torch.set_num_threads(2)

PARAMS = random_params(0)
GIB = 2**30


def test_loss_and_gradient_match_without_remat():
    """The loss and its image gradient at 64x48 (FP32) with the trunk
    rematerialised, held to the JAX package's remat bar
    (``tests/test_banded.py``: loss rtol 2e-5, gradient rtol 5e-4 with atol
    3e-6). On the CPU both came out bit-identical: the autograd graph is
    the same and the recompute repeats the forward's ops."""
    _, params, consts, state = build_step(48, 64, device="cpu")
    x0 = state.image

    def value_and_grad(remat):
        x = x0.clone().requires_grad_(True)
        loss = build_loss_fn(StepConfig(remat=remat))(x, params, consts)
        (g,) = torch.autograd.grad(loss, x)
        return loss.detach().numpy(), g.numpy()

    loss, grad = value_and_grad(False)
    r_loss, r_grad = value_and_grad(True)
    np.testing.assert_allclose(r_loss, loss, rtol=2e-5)
    np.testing.assert_allclose(r_grad, grad, rtol=5e-4, atol=3e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_moments_backward_matches_autograd(dtype):
    """The moments' one-product backward ((G + Gᵀ) f plus the mean's
    gradient, the JAX package's ``srm_outer`` VJP) against autograd's
    backward of the same ops, on features of the trunk's dtype."""
    rng = np.random.RandomState(0)
    f0 = torch.from_numpy(rng.normal(size=(1, 8, 12, 10)).astype(np.float32)).to(dtype)
    g_mean = torch.from_numpy(rng.normal(size=(1, 8)).astype(np.float32))
    g_srm = torch.from_numpy(rng.normal(size=(1, 8, 8)).astype(np.float32))

    def grad(moments):
        f = f0.clone().requires_grad_(True)
        mean, srm = moments(f)
        (g,) = torch.autograd.grad((mean * g_mean).sum() + (srm * g_srm).sum(), f)
        return mean.detach(), srm.detach(), g.float()

    def plain(f):
        x = f.float().flatten(2)
        return x.mean(2), x @ x.transpose(1, 2) / x.shape[-1]

    got, ref = grad(L.w2_moments), grad(plain)
    for a, b in zip(got[:2], ref[:2]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=1e-7)
    tol = 1e-6 if dtype == torch.float32 else 1e-2  # bf16 rounds the gradient
    np.testing.assert_allclose(got[2].numpy(), ref[2].numpy(), rtol=tol, atol=tol)


def test_segments_end_at_every_tap():
    """Segments end after every pool below the last tap and at every tap."""
    taps = StepConfig().all_layers  # (1, 6, 11, 20, 22, 29)
    assert remat_segment_ends(taps) == [1, 4, 6, 9, 11, 18, 20, 22, 27, 29]
    assert remat_segment_ends((22,)) == [4, 9, 18, 22]


@pytest.mark.parametrize("style_loss", ["w2", "gram"])
def test_loss_terms_sum_to_the_loss(style_loss):
    """``build_loss_terms_fn``'s weighted terms, which take the moments as
    the loss does, sum to ``build_loss_fn``'s value, with remat."""
    cfg = StepConfig(remat=True, style_loss=style_loss)
    _, params, consts, state = build_step(48, 64, device="cpu", style_loss=style_loss,
                                          remat=True)
    with torch.no_grad():
        loss = build_loss_fn(cfg)(state.image, params, consts)
        terms = build_loss_terms_fn(cfg)(state.image, params, consts)
    assert len(terms) == 1 + len(cfg.style_layers) + len(cfg.content_layers)
    np.testing.assert_allclose(float(sum(terms.values())), float(loss), rtol=1e-5)


def test_engine_with_remat_matches_jax(content_pil, style_pil):
    """The 48 -> 68 px pyramid (``gen_scales(48, 64)`` is one scale), 8 + 8
    Adam iterations, both engines with ``remat=True``: per-iteration losses
    at rtol 2e-3 and the final image above 40 dB, the bar of
    ``tests/test_torch_configs.py``."""
    pyramid = dict(min_scale=48, end_scale=68, iterations=8, initial_iterations=8)
    jst = J.StyleTransfer(devices=1, weights=PARAMS, compute_dtype="float32",
                          sqrtm_impl="xla", w2_grad="trace", callback_chunk=8, remat=True)
    tst = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=8, remat=True)
    j_its, t_its = [], []
    jst.stylize(content_pil, [style_pil], callback=j_its.append, **pyramid)
    tst.stylize(content_pil, [style_pil], callback=t_its.append, **pyramid)

    assert [(i.w, i.h, i.i) for i in t_its] == [(i.w, i.h, i.i) for i in j_its]
    assert [(r["w"], r["h"], r["remat"]) for r in tst.remat_scales] == [
        (48, 36, True), (68, 51, True)]
    np.testing.assert_allclose([i.loss for i in t_its], [i.loss for i in j_its],
                               rtol=2e-3)
    j_img, t_img = jst.get_image_tensor(), tst.get_image_tensor()
    assert t_img.shape == j_img.shape == (51, 68, 3)
    mse = float(np.mean((t_img - j_img) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 40.0


def test_auto_rule():
    """``remat=None``: on a CUDA device by the predicted no-remat peak
    against 90% of its memory (the largest slab's under a mesh), on the CPU
    the JAX engine's rule."""
    card = 80 * GIB
    # 2896x2172 runs without remat under every optimizer; 8192x6144 (50.3
    # Mpx) FP32 rematerialises.
    for optimizer in OPTIMIZERS:
        for dtype in (None, torch.bfloat16):
            assert not auto_remat(2172, 2896, dtype, card, optimizer=optimizer)
        assert auto_remat(6144, 8192, None, card, optimizer=optimizer)
    # Adam's bf16 step holds 8192x6144 without.
    assert not auto_remat(6144, 8192, torch.bfloat16, card)
    assert auto_remat(9216, 12288, torch.bfloat16, card)
    # FP32 at 8192x6144: 2 ranks hold 25.2 Mpx slabs, under the card's
    # ceiling; 4 ranks' (2x2) slabs are smaller still.
    for grid in ((2, 1), (2, 2)):
        mesh = Mesh(grid=grid, rank=0, device=torch.device("cpu"))
        assert not auto_remat(6144, 8192, None, card, mesh)
    # The last of 2 slabs of 1086 rows is not the largest: 544 and 542.
    mesh = Mesh(grid=(2, 1), rank=1, device=torch.device("cpu"))
    at = predicted_peak_bytes(1086, 1448, None, mesh) / REMAT_MEMORY_SHARE
    assert at == predicted_peak_bytes(544, 1448) / REMAT_MEMORY_SHARE
    assert auto_remat(1086, 1448, None, at - 1, mesh)
    assert not auto_remat(1086, 1448, None, at + 1, mesh)
    # Off CUDA: the JAX engine's rule, above 14 Mpx of the canvas.
    for h, w in ((2172, 2896), (3072, 4096), (3500, 4000), (3501, 4000), (6144, 8192)):
        assert auto_remat(h, w) == auto_size_knobs(h, w, is_tpu=False)["remat"]
    assert not auto_remat(3500, 4000) and auto_remat(3501, 4000)


@pytest.mark.parametrize("choice", ["on", "off", "auto"])
def test_cli_remat_choices(tmp_path, content_pil, style_pil, choice):
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    content_pil.resize((64, 48)).save(content)
    style_pil.save(style)
    weights, trace = tmp_path / "w.npz", tmp_path / "trace.json"
    np.savez(weights, **PARAMS)
    tcli.main([str(content), str(style), "-o", str(tmp_path / "out.png"), "--trace",
               str(trace), "--devices", "cpu", "--end-scale", "64", "-i", "2", "-ii", "2",
               "--vgg-weights", str(weights), "--remat", choice])
    t = json.loads(trace.read_text())
    assert all(np.isfinite(it["loss"]) for it in t["iterates"])
    # auto: the CPU's (the JAX engine's) rule leaves 64x48 without remat.
    assert t["remat"] == [{"w": 64, "h": 48, "remat": choice == "on",
                           "predicted_peak_mib": None}]
    # CPU tensors never launch the kernels.
    assert t["kernel_launches"] == {"ns_sqrtm_yz": 0, "ns_sqrtm": 0, "lyap_bwd": 0}
