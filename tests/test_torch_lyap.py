"""PyTorch port: the NS square root with the Lyapunov backward (``--w2-grad
lyap``), its CUDA kernels' wrappers, and the lyap path as a whole.

The port's plain ``sqrtm_ns_lyap`` is held, value and gradient, against the
JAX package's XLA version and against its Pallas kernels run in interpret
mode; the W2 loss and the two-scale pyramid in lyap mode against the JAX
package. The CUDA kernels themselves run only on the card (``-m cuda``).
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu
from PIL import Image

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.ops import sqrtm as JS
from style_transfer_tpu.ops.pallas.ns_sqrtm import sqrtm_ns_lyap_pallas
from style_transfer_tpu_torch import cli as tcli
from style_transfer_tpu_torch.ops import losses as TL
from style_transfer_tpu_torch.ops import sqrtm as TS
from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

torch.set_num_threads(2)

ITERS = 12
PARAMS = random_params(0)


def _mats(g, n, kind, seed=0):
    """SPD (full rank + 1e-3 I) or rank-deficient (rank n/4) + 1e-4 I."""
    rng = np.random.RandomState(seed)
    r = n if kind == "spd" else n // 4
    eps = 1e-3 if kind == "spd" else 1e-4
    x = rng.randn(g, n, r).astype(np.float32)
    return (x @ x.transpose(0, 2, 1) / n + eps * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


CASES = [(2, 64, "spd"), (1, 128, "spd"), (2, 64, "lowrank"), (1, 128, "lowrank")]


def _rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _port_value_grad(a, w, fn):
    x = torch.from_numpy(a).requires_grad_(True)
    v = fn(x, ITERS)
    (g,) = torch.autograd.grad((v * torch.from_numpy(w)).sum(), x)
    return v.detach().numpy(), g.numpy()


def _jax_value_grad(a, w, fn):
    val = np.asarray(fn(jnp.asarray(a), ITERS))
    grad = jax.grad(lambda m: jnp.sum(fn(m, ITERS) * jnp.asarray(w)))(jnp.asarray(a))
    return val, np.asarray(grad)


@pytest.mark.parametrize("g,n,kind", CASES)
def test_sqrtm_ns_lyap_matches_jax_xla(g, n, kind):
    a = _mats(g, n, kind)
    w = np.random.RandomState(1).randn(g, n, n).astype(np.float32)
    tv, tg = _port_value_grad(a, w, TS.sqrtm_ns_lyap)
    jv, jg = _jax_value_grad(a, w, JS.sqrtm_ns_lyap)
    # Both are FP32 matmul chains of the same iterations, summed in their
    # own order: 1e-4 of the max (measured at most 8.7e-6 on the value and
    # 7.0e-6 on the gradient, both rank-deficient).
    assert _rel(tv, jv) < 1e-4
    assert _rel(tg, jg) < 1e-4


@pytest.mark.parametrize("g,n,kind", CASES)
def test_sqrtm_ns_lyap_matches_pallas_interpret(g, n, kind):
    a = _mats(g, n, kind)
    w = np.random.RandomState(2).randn(g, n, n).astype(np.float32)
    tv, tg = _port_value_grad(a, w, TS.sqrtm_ns_lyap)
    with pltpu.force_tpu_interpret_mode():
        jv, jg = _jax_value_grad(a, w, sqrtm_ns_lyap_pallas)
    # The Pallas kernels multiply in bf16x3 (about 16 mantissa bits): 5e-3
    # of the max (measured at most 3.0e-4 on the value and 3.5e-4 on the
    # gradient, both rank-deficient).
    assert _rel(tv, jv) < 5e-3
    assert _rel(tg, jg) < 5e-3


def test_dispatching_lyap_on_cpu_equals_plain():
    a = _mats(2, 64, "spd", seed=3)
    w = np.random.RandomState(4).randn(2, 64, 64).astype(np.float32)
    before = (K.ns_sqrtm.launches, K.lyap_bwd.launches)
    pv, pg = _port_value_grad(a, w, TS.sqrtm_ns_lyap)
    kv, kg = _port_value_grad(a, w, K.sqrtm_ns_lyap)
    np.testing.assert_array_equal(kv, pv)
    np.testing.assert_array_equal(kg, pg)
    # The wrappers themselves, batched and unbatched.
    at, gt = torch.from_numpy(a), torch.from_numpy(w)
    y = K.ns_sqrtm(at, ITERS)
    assert torch.equal(y, K.ns_sqrtm_plain(at, ITERS))
    assert torch.equal(K.ns_sqrtm(at[1], ITERS), y[1])
    q = K.lyap_bwd(y, gt, ITERS)
    assert torch.equal(q, K.lyap_bwd_plain(y, gt, ITERS))
    assert torch.equal(K.lyap_bwd(y[0], gt[0], ITERS), q[0])
    assert (K.ns_sqrtm.launches, K.lyap_bwd.launches) == before


@pytest.mark.parametrize("call,exc", [
    (lambda: K.ns_sqrtm(torch.eye(8, dtype=torch.float64)), TypeError),
    (lambda: K.ns_sqrtm(torch.zeros(2, 8, 6)), ValueError),
    (lambda: K.ns_sqrtm(torch.zeros(2, 2, 8, 8)), ValueError),
    (lambda: K.ns_sqrtm(torch.zeros(0, 8, 8)), ValueError),
    (lambda: K.ns_sqrtm(torch.eye(8), -1), ValueError),
    (lambda: K.lyap_bwd(torch.eye(8), torch.eye(8, dtype=torch.float64)), TypeError),
    (lambda: K.lyap_bwd(torch.eye(8, dtype=torch.float16), torch.eye(8)), TypeError),
    (lambda: K.lyap_bwd(torch.zeros(8), torch.zeros(8)), ValueError),
    (lambda: K.lyap_bwd(torch.zeros(1, 8, 8), torch.zeros(2, 8, 8)), ValueError),
    (lambda: K.lyap_bwd(torch.eye(8), torch.eye(8)[None]), ValueError),
], ids=["ns-f64", "ns-nonsquare", "ns-4d", "ns-empty", "ns-iters",
        "lyap-g-f64", "lyap-z-f16", "lyap-1d", "lyap-batch-mismatch",
        "lyap-rank-mismatch"])
def test_wrappers_reject_bad_input(call, exc):
    with pytest.raises(exc):
        call()


def test_w2_losses_go_through_the_dispatching_sqrtm(monkeypatch):
    """Both W2 loss entry points reach the kernel wrappers, forward and
    backward, and the backward hands B3 a contiguous gradient."""
    assert TL.sqrtm_ns_lyap is K.sqrtm_ns_lyap
    calls = []

    def spy(name):
        fn = getattr(K, name)

        def wrapped(*args, **kw):
            calls.append((name, all(t.is_contiguous() for t in args
                                    if isinstance(t, torch.Tensor))))
            return fn(*args, **kw)

        monkeypatch.setattr(K, name, wrapped)

    spy("ns_sqrtm")
    spy("lyap_bwd")
    expect = [("ns_sqrtm", True), ("lyap_bwd", True)]
    rng = np.random.RandomState(5)
    feats = torch.from_numpy(np.abs(rng.randn(1, 16, 5, 7)).astype(np.float32))
    tgt = TL.w2_target(*TL.w2_moments(
        torch.from_numpy(np.abs(rng.randn(1, 16, 6, 6)).astype(np.float32))))

    x = feats.clone().requires_grad_(True)
    torch.autograd.grad(TL.w2_loss(x, tgt), x)
    assert calls == expect
    calls.clear()

    mean, srm = TL.w2_moments(feats)
    cov = TL.moments_to_cov(mean, srm).requires_grad_(True)
    torch.autograd.grad(TL.w2_losses_batched(mean, cov, tgt).sum(), cov)
    assert calls == expect
    calls.clear()

    # A plain sum hands the backward an expanded (stride 0) gradient.
    a = torch.from_numpy(_mats(1, 16, "spd")).requires_grad_(True)
    torch.autograd.grad(K.sqrtm_ns_lyap(a, ITERS).sum(), a)
    assert calls == expect


def test_w2_losses_batched_lyap_matches_jax():
    rng = np.random.RandomState(6)
    g, c = 2, 32
    means = rng.rand(g, c).astype(np.float32)
    covs = _mats(g, c, "spd", seed=7)
    t_mean = rng.rand(g, c).astype(np.float32)
    t_cov = _mats(g, c, "spd", seed=8)
    vals, vecs = np.linalg.eigh(t_cov.astype(np.float64))
    t_cs = ((vecs * np.sqrt(vals)[:, None, :]) @ vecs.transpose(0, 2, 1)
            ).astype(np.float32)
    w = np.asarray([0.75, 0.25], np.float32)

    def jfn(cv):
        tgt = JL.W2Target(jnp.asarray(t_mean), jnp.asarray(t_cov), jnp.asarray(t_cs))
        return jnp.sum(JL.w2_losses_batched(jnp.asarray(means), cv, tgt, ITERS)
                       * jnp.asarray(w))

    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(covs))
    tgt = TL.W2Target(*(torch.from_numpy(v) for v in (t_mean, t_cov, t_cs)))
    cv = torch.from_numpy(covs).requires_grad_(True)
    tv = (TL.w2_losses_batched(torch.from_numpy(means), cv, tgt, ITERS)
          * torch.from_numpy(w)).sum()
    (tg,) = torch.autograd.grad(tv, cv)
    # FP32 on both sides: rtol 1e-4 (measured 9.0e-8 on the value and 4.7e-6
    # of the gradient's max).
    np.testing.assert_allclose(tv.item(), float(jv), rtol=1e-4)
    assert _rel(tg.numpy(), np.asarray(jg)) < 1e-4


def test_two_scale_lyap_pyramid_matches_jax(content_pil, style_pil):
    before = (K.ns_sqrtm.launches, K.lyap_bwd.launches)
    kw = dict(min_scale=48, end_scale=68, iterations=5, initial_iterations=5)
    jst = J.StyleTransfer(devices=1, weights=PARAMS, compute_dtype="float32",
                          sqrtm_impl="xla", w2_grad="lyap", callback_chunk=5)
    tst = T.StyleTransfer(device="cpu", weights=PARAMS, w2_grad="lyap",
                          callback_chunk=5)
    j_its, t_its = [], []
    jst.stylize(content_pil, [style_pil], callback=j_its.append, **kw)
    tst.stylize(content_pil, [style_pil], callback=t_its.append, **kw)
    assert [(i.w, i.h, i.i) for i in t_its] == [(i.w, i.h, i.i) for i in j_its]
    assert {(i.w, i.h) for i in t_its} == {(48, 36), (68, 51)}
    # The JAX package's own bar against its torch trajectory, rtol 2e-3
    # (measured 2.6e-6).
    np.testing.assert_allclose([i.loss for i in t_its], [i.loss for i in j_its],
                               rtol=2e-3)
    j_img, t_img = jst.get_image_tensor(), tst.get_image_tensor()
    psnr = 10 * np.log10(1.0 / max(float(np.mean((t_img - j_img) ** 2)), 1e-12))
    assert psnr > 40.0, psnr  # measured 96.6 dB
    assert (K.ns_sqrtm.launches, K.lyap_bwd.launches) == before  # CPU: plain


def test_cli_lyap_writes_output_and_trace(tmp_path, content_pil, style_pil):
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    content_pil.resize((64, 48)).save(content)
    style_pil.save(style)
    out, trace = tmp_path / "out.png", tmp_path / "trace.json"
    weights = tmp_path / "w.npz"
    np.savez(weights, **PARAMS)
    tcli.main([str(content), str(style), "-o", str(out), "--trace", str(trace),
               "--devices", "cpu", "--end-scale", "64", "-i", "3", "-ii", "3",
               "--w2-grad", "lyap", "--vgg-weights", str(weights)])
    with Image.open(out) as img:
        assert img.size == (64, 48)
    t = json.loads(trace.read_text())
    assert t["args"]["w2_grad"] == "lyap" and t["args"]["optimizer"] == "adam"
    assert [it["i"] for it in t["iterates"]] == [1, 2, 3]
    assert all(np.isfinite(it["loss"]) for it in t["iterates"])


@pytest.mark.cuda
@pytest.mark.parametrize("g,n", [(1, 64), (1, 100), (1, 256), (1, 300), (2, 512)])
def test_kernels_match_plain_on_card(g, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.from_numpy(_mats(g, n, "lowrank", seed=9)).cuda()
    gr = torch.from_numpy(
        np.random.RandomState(10).randn(g, n, n).astype(np.float32)).cuda()
    before = (K.ns_sqrtm.launches, K.lyap_bwd.launches)
    y = K.ns_sqrtm(a, ITERS)
    q = K.lyap_bwd(y, gr, ITERS)
    py = K.ns_sqrtm_plain(a, ITERS)
    pq = K.lyap_bwd_plain(y, gr, ITERS)
    torch.cuda.synchronize()
    assert (K.ns_sqrtm.launches, K.lyap_bwd.launches) == (before[0] + 1, before[1] + 1)
    # The same tolerances as chip_smoke.py: Y to 1e-4 of max|Y|, Q to 1e-3
    # of max|Q|.
    assert ((y - py).abs().max() / py.abs().max()).item() < 1e-4
    assert ((q - pq).abs().max() / pq.abs().max()).item() < 1e-3


@pytest.mark.cuda
@pytest.mark.parametrize("n", [64, 200])
def test_kernels_past_one_launch_on_card(n):
    """30 iterations at C <= 256: the cluster regime's plan of 59-60 steps
    takes two launches of 48 steps at most (csrc/ns_sqrtm.cu); the wrapper
    still counts one call. Z is not compared here: past convergence the
    coupled iteration's Z drifts from the FP32 chain's as iterations go
    on, whatever the launches (Y, tr(Y) and Q do not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    iters = 30
    a = torch.from_numpy(_mats(1, n, "lowrank", seed=11)).cuda()
    gr = torch.from_numpy(
        np.random.RandomState(12).randn(1, n, n).astype(np.float32)).cuda()
    before = (K.ns_sqrtm_yz.launches, K.ns_sqrtm.launches, K.lyap_bwd.launches)
    yz, _ = K.ns_sqrtm_yz(a, iters)
    y = K.ns_sqrtm(a, iters)
    q = K.lyap_bwd(y, gr, iters)
    py = K.ns_sqrtm_plain(a, iters)
    pq = K.lyap_bwd_plain(y, gr, iters)
    torch.cuda.synchronize()
    after = (K.ns_sqrtm_yz.launches, K.ns_sqrtm.launches, K.lyap_bwd.launches)
    assert after == tuple(b + 1 for b in before)
    torch.testing.assert_close(yz.diagonal(dim1=-2, dim2=-1).sum(-1),
                               py.diagonal(dim1=-2, dim2=-1).sum(-1), rtol=1e-4, atol=0)
    assert ((y - py).abs().max() / py.abs().max()).item() < 1e-4
    assert ((q - pq).abs().max() / pq.abs().max()).item() < 1e-3
