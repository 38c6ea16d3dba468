"""PyTorch port: malformed inputs fail loudly and early, edge configurations
run (the port's counterpart of ``tests/test_robustness.py``, on the CPU)."""

import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch import StyleTransfer
from style_transfer_tpu_torch.step import StepConfig

torch.set_num_threads(2)

PARAMS = random_params(0)
ONE_SCALE = dict(min_scale=64, end_scale=64)


def eng(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("weights", PARAMS)
    kw.setdefault("callback_chunk", 5)
    return StyleTransfer(**kw)


def test_unknown_style_loss_rejected():
    with pytest.raises(ValueError, match="unknown style_loss"):
        StepConfig(style_loss="bogus")
    with pytest.raises(ValueError, match="unknown style_loss"):
        eng(style_loss="bogus")


def test_unknown_optimizer_rejected(content_pil, style_pil):
    st = eng()
    with pytest.raises(ValueError, match="optimizer"):
        st.stylize(content_pil, [style_pil], optimizer="sgd", iterations=1,
                   initial_iterations=1, **ONE_SCALE)


def test_unknown_pooling_rejected():
    from style_transfer_tpu_torch.ops.pooling import pool2x2

    with pytest.raises(ValueError, match="pooling"):
        pool2x2(torch.zeros((1, 3, 4, 4)), "median")
    with pytest.raises(ValueError, match="pooling"):
        eng(pooling="median")


def test_image_too_small_for_style_layers():
    from style_transfer_tpu_torch.models.vgg import extract_features

    st = eng()
    with pytest.raises(ValueError, match="at least"):
        extract_features(st.params, torch.zeros((1, 3, 8, 8)), [29])


def test_min_scale_clamped_to_end_scale(content_pil, style_pil):
    """min_scale > end_scale is clamped (reference behavior, ref :365)."""
    st = eng()
    its = []
    st.stylize(content_pil, [style_pil], min_scale=512, end_scale=64,
               iterations=3, initial_iterations=3, callback=its.append)
    assert {(i.w, i.h) for i in its} == {(64, 48)}


def test_runs_without_a_callback(content_pil, style_pil):
    st = eng()
    img = st.stylize(content_pil, [style_pil], iterations=2, initial_iterations=2,
                     **ONE_SCALE)
    assert img is not None and img.size == (64, 48)


def test_grayscale_and_rgba_inputs(tmp_path):
    """Non-RGB inputs are converted on load (ICC path, ref cli.py:36)."""
    from style_transfer_tpu_torch.io_color import load_image

    g = tmp_path / "g.png"
    Image.new("L", (70, 70), 128).save(g)
    a = tmp_path / "a.png"
    Image.new("RGBA", (70, 70), (10, 20, 30, 255)).save(a)
    st = eng()
    img = st.stylize(load_image(g), [load_image(a)], iterations=2, initial_iterations=2,
                     **ONE_SCALE)
    assert img.mode == "RGB" and img.size == (64, 64)


def test_many_styles(content_pil):
    rng = np.random.RandomState(0)
    styles = [Image.fromarray(rng.randint(0, 255, (64 + 8 * i, 64, 3), np.uint8))
              for i in range(4)]
    st = eng()
    its = []
    st.stylize(content_pil, styles, iterations=4, initial_iterations=4,
               callback=its.append, **ONE_SCALE)
    assert len(its) == 4 and np.isfinite([i.loss for i in its]).all()


def test_negative_style_weights_blend(content_pil, style_pil):
    """The reference normalizes by the sum of |w|; negative weights are
    legal ('subtract this style')."""
    style2 = Image.fromarray(np.random.RandomState(3).randint(0, 255, (64, 64, 3), np.uint8))
    st = eng()
    its = []
    st.stylize(content_pil, [style_pil, style2], style_weights=[2.0, -1.0],
               iterations=4, initial_iterations=4, callback=its.append, **ONE_SCALE)
    assert len(its) == 4 and np.isfinite([i.loss for i in its]).all()
    with pytest.raises(ValueError, match="same length"):
        st.stylize(content_pil, [style_pil, style2], style_weights=[1.0], iterations=1,
                   initial_iterations=1, **ONE_SCALE)
