"""PyTorch port: VGG-19 activation fingerprints (``models/fingerprint.py``).

The committed random-weight fixture, made by the JAX package's trunk, must
reproduce through the port's trunk (NCHW inside, NHWC in the file), the
check must catch the two port bugs shape validation misses, and the port's
``make_fingerprint`` must agree with the JAX one."""

from pathlib import Path

import numpy as np
import pytest
import torch

from style_transfer_tpu.models import fingerprint as JF
from style_transfer_tpu_torch.models import fingerprint as FP
from style_transfer_tpu_torch.models.weights import random_params

torch.set_num_threads(2)

FIXTURE = Path(__file__).parent / "fixtures" / "vgg19_random_he0_fingerprint.json"


def test_committed_fixture_reproduces():
    fp = FP.load_fingerprint(FIXTURE)
    assert FP.check_fingerprint(fp, random_params(0), device="cpu") == []


def test_detects_transpose_slip():
    """A transposed square kernel passes shape validation but not the
    checksums, nor (with them off) the activation statistics."""
    params = random_params(0)
    fp = FP.load_fingerprint(FIXTURE)
    bad = dict(params)
    bad["conv2_kernel"] = np.transpose(params["conv2_kernel"], (0, 1, 3, 2))
    problems = FP.check_fingerprint(fp, bad, device="cpu")
    assert any("sha256" in p for p in problems)
    assert any("tap" in p for p in problems), problems
    assert FP.check_fingerprint(fp, bad, check_checksums=False, device="cpu")


def test_detects_layer_offset():
    """Two same-shape deep convs swapped change no shape but fail the
    activation check."""
    params = random_params(0)
    bad = dict(params)
    for kind in ("kernel", "bias"):
        bad[f"conv23_{kind}"], bad[f"conv25_{kind}"] = (
            params[f"conv25_{kind}"], params[f"conv23_{kind}"])
    problems = FP.check_fingerprint(FP.load_fingerprint(FIXTURE), bad,
                                    check_checksums=False, device="cpu")
    assert problems, "activation statistics failed to detect swapped layers"


def test_make_fingerprint_matches_jax():
    """Same format, checksums, NHWC shapes and sample indices; statistics to
    rtol 1e-6 (measured 5.1e-8) and samples to 1e-5 absolute (measured
    3.9e-6)."""
    params = random_params(0)
    got = FP.make_fingerprint(params, source="random-he-0", device="cpu")
    want = JF.make_fingerprint(params, source="random-he-0")
    for key in ("format", "source", "taps", "checksums"):
        assert got[key] == want[key], key
    assert got["activations"].keys() == want["activations"].keys()
    for tap, w in want["activations"].items():
        g = got["activations"][tap]
        assert g["shape"] == w["shape"] and g["sample_idx"] == w["sample_idx"], tap
        for stat in ("mean", "std", "l2"):
            assert g[stat] == pytest.approx(w[stat], rel=1e-6), (tap, stat)
        np.testing.assert_allclose(g["samples"], w["samples"], rtol=0, atol=1e-5)
    assert FP.check_fingerprint(got, params, device="cpu") == []
    assert FP.check_fingerprint(want, params, device="cpu") == []


@pytest.mark.cuda
def test_committed_fixture_reproduces_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    fp = FP.load_fingerprint(FIXTURE)
    assert FP.check_fingerprint(fp, random_params(0), device="cuda:0") == []
