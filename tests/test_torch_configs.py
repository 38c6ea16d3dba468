"""PyTorch port: BASELINE config #4's options against the JAX engine, on the
CPU.

Gram style loss, scaled content loss, average and L2 pooling, the style
image's scale (``style_scale_fac`` with ``align``, ``style_size``) and the
``style_stats`` init, each through both engines' two-scale pyramid 48 ->
68 px (8 + 8 Adam iterations) with the same random VGG-19 weights in
float32. The port's NS wrapper takes its plain version on CPU tensors; its
grouped calls are counted here as the card would count the B1 launches. The cases that differ
only in ``stylize``'s options share one JAX engine (reseeded), which keeps
its compiled programs: a JAX engine's first pyramid here is mostly compile.
"""

import numpy as np
import pytest
import torch

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

torch.set_num_threads(2)

PARAMS = random_params(0)
PYRAMID = dict(min_scale=48, end_scale=68, iterations=8, initial_iterations=8)

# (engine options, stylize options, the canvases). Measured max relative
# loss difference / final-image PSNR against the JAX engine: average
# 2.8e-5 / 76.8 dB, l2 2.3e-6 / 104.5 dB, gram 1.7e-6 / 87.2 dB, scaled
# 1.9e-4 / 59.2 dB, style_scale_fac 0.7 with align 8 3.2e-5 / 75.0 dB,
# style_size 40 9.9e-5 / 61.5 dB, style_stats 2.0e-6 / 116.9 dB.
CASES = {
    "average": ({"pooling": "average"}, {}, [(48, 36), (68, 51)]),
    "l2": ({"pooling": "l2"}, {}, [(48, 36), (68, 51)]),
    "gram": ({"style_loss": "gram"}, {}, [(48, 36), (68, 51)]),
    "scaled": ({"content_loss": "scaled"}, {}, [(48, 36), (68, 51)]),
    "style_stats": ({}, {"init": "style_stats"}, [(48, 36), (68, 51)]),
    "style_size": ({}, {"style_size": 40}, [(48, 36), (68, 51)]),
    "style_scale_fac-align": ({}, {"style_scale_fac": 0.7, "align": 8},
                              [(48, 32), (64, 48)]),
}


@pytest.fixture(scope="module")
def jax_engine():
    """The JAX engine of the given options, made once per options and
    reseeded to 0 (a new port engine's seed) at each use."""
    engines = {}

    def get(**engine_kw):
        key = tuple(sorted(engine_kw.items()))
        if key not in engines:
            engines[key] = J.StyleTransfer(
                devices=1, weights=PARAMS, compute_dtype="float32", sqrtm_impl="xla",
                w2_grad="trace", callback_chunk=8, **engine_kw)
        engines[key].seed(0)
        return engines[key]

    return get


@pytest.mark.parametrize("case", list(CASES))
def test_config4_option_matches_jax(case, content_pil, style_pil, monkeypatch, jax_engine):
    engine_kw, stylize_kw, canvases = CASES[case]
    jst = jax_engine(**engine_kw)
    tst = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=8, **engine_kw)
    ns_calls = []
    grouped = K.ns_sqrtm_yz_groups
    monkeypatch.setattr(K, "ns_sqrtm_yz_groups",
                        lambda mats, *a: ns_calls.append(len(mats)) or grouped(mats, *a))
    j_its, t_its = [], []
    jst.stylize(content_pil, [style_pil], callback=j_its.append, **PYRAMID, **stylize_kw)
    tst.stylize(content_pil, [style_pil], callback=t_its.append, **PYRAMID, **stylize_kw)

    assert [(i.w, i.h, i.i) for i in t_its] == [(i.w, i.h, i.i) for i in j_its]
    assert sorted({(i.w, i.h) for i in t_its}) == canvases
    # rtol 2e-3, tests/test_torch_engine.py's bar against the JAX engine.
    np.testing.assert_allclose([i.loss for i in t_its], [i.loss for i in j_its],
                               rtol=2e-3)
    j_img, t_img = jst.get_image_tensor(), tst.get_image_tensor()
    assert t_img.shape == j_img.shape == (canvases[-1][1], canvases[-1][0], 3)
    mse = float(np.mean((t_img - j_img) ** 2))
    assert 10 * np.log10(1.0 / max(mse, 1e-12)) > 40.0
    # The W2 loss takes one grouped square root per iteration (16), of its
    # four channel groups: on a card, 16 launches of B1. Gram takes none.
    assert ns_calls == ([] if case == "gram" else [4] * 16)
    assert K.ns_sqrtm_yz.launches == 0  # CPU tensors never launch the kernel
