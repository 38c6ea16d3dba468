"""PyTorch port: VGG-19 parameter handling against the JAX package."""

import numpy as np
import pytest
import torch

from style_transfer_tpu.models import weights as JW
from style_transfer_tpu_torch.models import weights as TW

torch.set_num_threads(2)


def test_random_params_bit_identical_to_jax():
    # Exact equality: the same RandomState draws in the same order.
    jp, tp = JW.random_params(0), TW.random_params(0)
    assert jp.keys() == tp.keys()
    for k in jp:
        assert jp[k].dtype == tp[k].dtype == np.float32
        np.testing.assert_array_equal(jp[k], tp[k])
    assert TW.CONV_INDICES == JW.CONV_INDICES
    assert TW.CONV_CHANNELS == JW.CONV_CHANNELS
    assert TW.POOL_INDICES == JW.POOL_INDICES


def test_params_from_jax_oihw_round_trip(tmp_path):
    params = TW.random_params(1)
    out = TW.params_from_jax(params)
    for idx in TW.CONV_INDICES:
        cin, cout = TW.CONV_CHANNELS[idx]
        k = out[f"conv{idx}_kernel"]
        assert k.dtype == torch.float32 and tuple(k.shape) == (cout, cin, 3, 3)
        assert tuple(out[f"conv{idx}_bias"].shape) == (cout,)
        # OIHW -> HWIO gives back the input bit for bit.
        np.testing.assert_array_equal(
            k.permute(2, 3, 1, 0).numpy(), params[f"conv{idx}_kernel"])
    # The .npz store round-trips too and is readable by the JAX package.
    path = tmp_path / "w.npz"
    TW.save_params(params, path)
    for loaded in (TW.load_params(path), JW.load_params(path)):
        for k in params:
            np.testing.assert_array_equal(loaded[k], params[k])


@pytest.mark.parametrize("key,shape", [
    ("conv0_kernel", (3, 3, 64, 3)),  # OIHW order where HWIO is expected
    ("conv34_bias", (511,)),
])
def test_validate_rejects_wrong_shapes(key, shape):
    params = TW.random_params(0)
    params[key] = np.zeros(shape, np.float32)
    with pytest.raises(ValueError, match="expected"):
        TW._validate(params, "test")
    with pytest.raises(ValueError):
        TW.params_from_jax(params)


def test_validate_rejects_missing_layer():
    params = TW.random_params(0)
    del params["conv10_kernel"]
    with pytest.raises(ValueError, match="missing weights for conv layer 10"):
        TW._validate(params, "test")
