"""PyTorch port: the slice as a whole against the JAX engine, on the CPU.

Both engines run the same random VGG-19 weights in float32 on the conftest
images; the port's kernel wrapper takes its plain version on CPU tensors.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from PIL import Image

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch import cli as tcli
from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

torch.set_num_threads(2)

PARAMS = random_params(0)
REPO = Path(__file__).resolve().parent.parent


def _run(st, content, styles, **kw):
    its = []
    st.stylize(content, styles, callback=its.append, **kw)
    return its


def _engines():
    jst = J.StyleTransfer(devices=1, weights=PARAMS, compute_dtype="float32",
                          sqrtm_impl="xla", w2_grad="trace", callback_chunk=10)
    tst = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=10)
    return jst, tst


def test_two_scale_pyramid_matches_jax(content_pil, style_pil):
    kw = dict(min_scale=48, end_scale=68, iterations=10, initial_iterations=10)
    jst, tst = _engines()
    j_its = _run(jst, content_pil, [style_pil], **kw)
    t_its = _run(tst, content_pil, [style_pil], **kw)
    assert [(i.w, i.h, i.i, i.i_max) for i in t_its] == [
        (i.w, i.h, i.i, i.i_max) for i in j_its]
    assert {(i.w, i.h) for i in t_its} == {(48, 36), (68, 51)}  # one crossing
    assert all(i.gpu_ram == 0 for i in t_its)
    # rtol 2e-3, the JAX package's own bar against its torch trajectory
    # (test_fullloop_torch.py): FP32 on both sides, drift compounding over
    # 20 Adam steps and a bicubic crossing (measured 1.1e-4).
    np.testing.assert_allclose([i.loss for i in t_its], [i.loss for i in j_its],
                               rtol=2e-3)
    j_img, t_img = jst.get_image_tensor(), tst.get_image_tensor()
    assert t_img.shape == j_img.shape == (51, 68, 3)
    mse = float(np.mean((t_img - j_img) ** 2))
    psnr = 10 * np.log10(1.0 / max(mse, 1e-12))
    assert psnr > 40.0, psnr  # measured 64.7 dB
    assert np.abs(t_img - j_img).mean() < 0.01  # measured 2.5e-4
    # CPU tensors never launch the kernel.
    assert K.ns_sqrtm_yz.launches == 0


def test_multi_style_negative_blend_matches_jax(content_pil, style_pil):
    style2 = Image.fromarray(
        np.random.RandomState(3).randint(0, 255, (60, 90, 3)).astype(np.uint8))
    kw = dict(min_scale=48, end_scale=48, iterations=5, initial_iterations=5,
              style_weights=[2, -1])
    jst, tst = _engines()
    j_its = _run(jst, content_pil, [style_pil, style2], **kw)
    t_its = _run(tst, content_pil, [style_pil, style2], **kw)
    assert len(t_its) == len(j_its) == 5
    # The blended covariance is indefinite here, so the target square root
    # is eigh with |eigenvalue| semantics in each framework's own solver:
    # same 2e-3 bar (measured 1.7e-6).
    np.testing.assert_allclose([i.loss for i in t_its], [i.loss for i in j_its],
                               rtol=2e-3)
    # The per-term diagnostic of the final iterate, same bar (measured 7.8e-6).
    j_terms, t_terms = jst.loss_terms(), tst.loss_terms()
    assert t_terms.keys() == j_terms.keys()
    for k in j_terms:
        np.testing.assert_allclose(t_terms[k], j_terms[k], rtol=2e-3, err_msg=k)


@pytest.mark.parametrize("init", ["content", "gray", "uniform", "normal", "style_stats"])
def test_init_modes_bit_identical_to_jax(init, content_pil, style_pil):
    jst, tst = _engines()
    jst.seed(5)
    tst.seed(5)
    args = (init, content_pil, [style_pil], [1.0], (36, 48))
    j = np.asarray(jst._init_image(*args))
    t = tst._init_image(*args).numpy().transpose(0, 2, 3, 1)
    np.testing.assert_array_equal(t, j)


def test_lyap_and_other_optimizers_are_refused(content_pil, style_pil):
    """Every optimizer of the JAX engine runs, lbfgs-zoom here with the lyap
    gradient; an unknown one is refused as in the JAX engine."""
    st = T.StyleTransfer(device="cpu", weights=PARAMS, w2_grad="lyap")
    its = _run(st, content_pil, [style_pil], optimizer="lbfgs-zoom", min_scale=48,
               end_scale=48, iterations=3, initial_iterations=3)
    assert [i.i for i in its] == [1, 2, 3]
    assert its[-1].loss < its[0].loss
    with pytest.raises(ValueError, match="optimizer must be one of"):
        st.stylize(content_pil, [style_pil], optimizer="sgd")


def test_cli_writes_output_and_trace(tmp_path, content_pil, style_pil):
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    content_pil.resize((64, 48)).save(content)
    style_pil.save(style)
    out, trace = tmp_path / "out.png", tmp_path / "trace.json"
    weights = tmp_path / "w.npz"
    np.savez(weights, **PARAMS)
    tcli.main([str(content), str(style), "-o", str(out), "--trace", str(trace),
               "--devices", "cpu", "--end-scale", "64", "-i", "5", "-ii", "5",
               "--vgg-weights", str(weights)])
    with Image.open(out) as img:
        assert img.size == (64, 48)
        assert "icc_profile" in img.info
    t = json.loads(trace.read_text())
    assert [it["i"] for it in t["iterates"]] == [1, 2, 3, 4, 5]
    assert all(np.isfinite(it["loss"]) for it in t["iterates"])
    assert t["args"]["devices"] == ["cpu"] and t["args"]["end_scale"] == 64
    # TPU-only flags, unknown optimizers and unknown remat choices are
    # absent; lbfgs-zoom and --remat's three choices are offered.
    parser = tcli.build_parser(T.StyleTransfer.stylize)
    for flag in (["--sqrtm", "xla"], ["--remat", "sometimes"], ["--bands", "4"],
                 ["--optimizer", "sgd"]):
        with pytest.raises(SystemExit):
            parser.parse_args(["c", "s", *flag])
    assert parser.parse_args(["c", "s", "--optimizer", "lbfgs-zoom"]).optimizer == "lbfgs-zoom"
    assert [parser.parse_args(["c", "s", "--remat", c]).remat
            for c in ("on", "off", "auto")] == ["on", "off", "auto"]
    assert parser.parse_args(["c", "s"]).remat == "auto"


def test_port_imports_no_jax():
    code = ("import sys, style_transfer_tpu_torch, style_transfer_tpu_torch.cli, "
            "style_transfer_tpu_torch.utils.checkpoint, "
            "style_transfer_tpu_torch.web.server, style_transfer_tpu_torch.web.client, "
            "style_transfer_tpu_torch.zoom_lbfgs, style_transfer_tpu_torch.utils.metrics, "
            "style_transfer_tpu_torch.utils.lpips, "
            "style_transfer_tpu_torch.models.fingerprint, "
            "style_transfer_tpu_torch.parallel.launch, "
            "style_transfer_tpu_torch.parallel.multihost, "
            "style_transfer_tpu_torch.parallel.checks, style_transfer_tpu_torch.bench; "
            "sys.path.insert(0, 'tools'); "
            "import fidelity_torch, bench_pyramid_torch, profile_step_torch, "
            "lbfgs_determinacy_torch; "
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m == 'optax' or m.startswith('optax.') "
            "or m == 'style_transfer_tpu' or m.startswith('style_transfer_tpu.')]; "
            "assert not bad, bad")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
