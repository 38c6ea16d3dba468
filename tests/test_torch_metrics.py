"""PyTorch port: the fidelity metrics (PSNR, SSIM, VGG distance, LPIPS)
against the JAX package's on the same arrays, on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_metrics import _random_bundle

from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu.utils import lpips as JL
from style_transfer_tpu.utils import metrics as JM
from style_transfer_tpu_torch.models.weights import params_from_jax
from style_transfer_tpu_torch.utils import lpips as TL
from style_transfer_tpu_torch.utils import metrics as TM

torch.set_num_threads(2)


@pytest.fixture()
def imgs():
    rng = np.random.RandomState(0)
    a = rng.rand(48, 64, 3)
    noise = rng.randn(48, 64, 3) * 0.05
    return a, np.clip(a + noise, 0, 1)


def test_psnr_ssim_match_jax(imgs):
    """The same numpy code: equal to rtol 1e-12 (measured equal)."""
    a, b = imgs
    for fn in ("psnr", "ssim"):
        want = getattr(JM, fn)(a, b)
        assert getattr(TM, fn)(a, b) == pytest.approx(want, rel=1e-12)
    assert TM.psnr(a, a) == float("inf")
    assert TM.ssim(a, a) == pytest.approx(1.0, abs=1e-9)
    with pytest.raises(ValueError):
        TM.psnr(np.zeros((4, 4, 3)), np.zeros((5, 4, 3)))


def test_vgg_distance_matches_jax(imgs):
    """The port's FP32 trunk on the CPU, reduced in float64: rtol 1e-5
    (measured 1.9e-8), and ordered as the JAX package's own test asks."""
    a, b = imgs
    hwio = random_params(0)
    params = params_from_jax(hwio)
    got = TM.vgg_distance(a, b, params=params, device="cpu")
    want = JM.vgg_distance(a, b, params={k: jnp.asarray(v) for k, v in hwio.items()})
    assert got == pytest.approx(want, rel=1e-5)
    d_same = TM.vgg_distance(a, a, params=params, device="cpu")
    d_diff = TM.vgg_distance(a, np.flipud(a).copy(), params=params, device="cpu")
    assert d_same < 1e-10 and d_same < got < d_diff


@pytest.mark.parametrize("net", ["alex", "vgg16"])
def test_lpips_matches_jax(tmp_path, net):
    """Random bundles as the JAX package's tests build them: rtol 1e-5
    (measured 7.2e-8 alex, 1.7e-7 vgg16)."""
    path = _random_bundle(tmp_path, net)
    rng = np.random.RandomState(1)
    a = rng.rand(64, 64, 3)
    b = np.clip(a + rng.randn(64, 64, 3) * 0.1, 0, 1)
    bundle = TL.load_bundle(path)
    got = TL.lpips(a, b, bundle, device="cpu")
    assert got == pytest.approx(JL.lpips(a, b, JL.load_bundle(path)), rel=1e-5)
    assert TL.lpips(a, a, path, device="cpu") == pytest.approx(0.0, abs=1e-12)
    assert got > 0
    # The kernels are OIHW, turned once from the file's HWIO.
    kern = bundle["convs"][0][0]
    k = TL.LPIPS_NETS[net][0][1]
    assert tuple(kern.shape) == (TL.LPIPS_NETS[net][0][0], 3, k, k)


def test_lpips_rejects_bad_bundle(tmp_path):
    p = tmp_path / "bad.npz"
    np.savez(p, meta=np.frombuffer(b'{"format":"x"}', dtype=np.uint8))
    with pytest.raises(ValueError, match="not a stt-lpips v1 bundle"):
        TL.load_bundle(p)
    good = dict(np.load(_random_bundle(tmp_path, "alex")))
    good["conv1_kernel"] = good["conv1_kernel"].transpose(0, 1, 3, 2)  # HWOI
    np.savez(tmp_path / "transposed.npz", **good)
    with pytest.raises(ValueError, match="conv1 shape"):
        TL.load_bundle(tmp_path / "transposed.npz")


def test_perceptual_distance_switches(tmp_path, monkeypatch):
    """perceptual_distance reports real LPIPS iff a bundle resolves
    (explicit path or $STT_LPIPS_WEIGHTS), the labeled proxy otherwise; each
    value equals the JAX function's (rtol 1e-5)."""
    rng = np.random.RandomState(2)
    a = rng.rand(64, 64, 3)
    b = np.clip(a + rng.randn(64, 64, 3) * 0.1, 0, 1)
    hwio = random_params(0)
    params = params_from_jax(hwio)
    jparams = {k: jnp.asarray(v) for k, v in hwio.items()}

    monkeypatch.delenv("STT_LPIPS_WEIGHTS", raising=False)
    d0, kind0 = TM.perceptual_distance(a, b, params=params, device="cpu")
    j0, jkind0 = JM.perceptual_distance(a, b, params=jparams)
    assert kind0 == jkind0 == "vgg_distance_proxy"
    assert d0 == pytest.approx(j0, rel=1e-5)

    path = _random_bundle(tmp_path)
    d1, kind1 = TM.perceptual_distance(a, b, lpips_weights=str(path), device="cpu")
    assert kind1 == "lpips-alex" and d1 > 0

    monkeypatch.setenv("STT_LPIPS_WEIGHTS", str(path))
    d2, kind2 = TM.perceptual_distance(a, b, device="cpu")
    j2, jkind2 = JM.perceptual_distance(a, b)
    assert kind2 == jkind2 == "lpips-alex"
    assert d2 == pytest.approx(d1)
    assert d2 == pytest.approx(j2, rel=1e-5)


@pytest.mark.cuda
def test_metrics_on_the_card_match_cpu(tmp_path, imgs):
    """On the card: the VGG distance and LPIPS (both nets) equal the CPU's
    to rtol 1e-4 (FP32 convolutions; TF32 is off inside the metrics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    a, b = imgs
    params = params_from_jax(random_params(0))
    cpu = TM.vgg_distance(a, b, params=params, device="cpu")
    assert TM.vgg_distance(a, b, params=params, device="cuda:0") == pytest.approx(cpu, rel=1e-4)
    for net in ("alex", "vgg16"):
        bundle = TL.load_bundle(_random_bundle(tmp_path, net))
        got = TL.lpips(a, b, bundle, device="cuda:0")
        assert got == pytest.approx(TL.lpips(a, b, bundle, device="cpu"), rel=1e-4)
