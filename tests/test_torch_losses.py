"""PyTorch port: loss functions against the JAX package, value and image
gradient. The port's features are NCHW and the JAX package's NHWC, so inputs
are transposed at the boundary; statistics are channel-space in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.ops.sqrtm import trace_sqrtm_ns as j_trace_sqrtm
from style_transfer_tpu_torch.ops import losses as TL
from style_transfer_tpu_torch.ops.cuda.ns_sqrtm import trace_sqrtm_ns as t_trace_sqrtm

torch.set_num_threads(2)

# FP32 on both sides, sums taken in each framework's own order: rtol 1e-4
# of the value and of the gradient's max (measured values beside each test).
RTOL = 1e-4


def _feats(seed, shape=(1, 9, 11, 16)):
    """NHWC post-ReLU-like features (non-negative, some exact zeros)."""
    x = np.random.RandomState(seed).randn(*shape).astype(np.float32)
    return np.maximum(x, 0.0) + 0.05 * np.abs(x)


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _rel(x, ref):
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _check(jfn, tfn, x_nhwc):
    """Value and d/dx of a scalar loss of one NHWC feature input."""
    jv, jg = jax.value_and_grad(jfn)(jnp.asarray(x_nhwc))
    xt = _nchw(x_nhwc).requires_grad_(True)
    tv = tfn(xt)
    (tg,) = torch.autograd.grad(tv, xt)
    np.testing.assert_allclose(tv.item(), float(jv), rtol=RTOL)
    assert _rel(tg.numpy().transpose(0, 2, 3, 1), np.asarray(jg)) < RTOL


def test_content_and_scaled_mse():
    # measured: values <= 1.9e-7, gradients <= 1.9e-7
    x, t = _feats(0), _feats(1)
    jt, tt = jnp.asarray(t), _nchw(t)
    _check(lambda v: JL.content_mse(v, jt), lambda v: TL.content_mse(v, tt), x)
    _check(lambda v: JL.scaled_mse(v, jt), lambda v: TL.scaled_mse(v, tt), x)
    _check(lambda v: JL.content_scaled(v, jt), lambda v: TL.content_scaled(v, tt), x)


def test_gram_loss():
    # measured: Gram 1.3e-7, value 5.1e-7, gradient 7.4e-7
    x, s = _feats(2), _feats(3, (1, 7, 5, 16))
    jt = JL.gram_matrix(jnp.asarray(s))
    tt = TL.gram_matrix(_nchw(s))
    assert _rel(tt.numpy(), np.asarray(jt)) < RTOL
    _check(lambda v: JL.gram_loss(v, jt), lambda v: TL.gram_loss(v, tt), x)


def test_w2_moments_and_cov():
    # measured: mean 2.7e-7, srm 3.3e-7, cov 4.0e-7
    x = _feats(4)
    jm, js = JL.w2_moments(jnp.asarray(x))
    tm, ts = TL.w2_moments(_nchw(x))
    assert _rel(tm.numpy(), np.asarray(jm)) < RTOL
    assert _rel(ts.numpy(), np.asarray(js)) < RTOL
    jc = JL.moments_to_cov(jm, js, 1e-4)
    tc = TL.moments_to_cov(tm, ts, 1e-4)
    assert _rel(tc.numpy(), np.asarray(jc)) < RTOL


def test_w2_target_eigh():
    # Both take the eigendecomposition in FP32 with their own solver; the
    # square root agrees to 1e-3 of its max (measured 9.9e-7), and the
    # (mean, cov) fields, which do not go through eigh, to RTOL.
    m, s = JL.w2_moments(jnp.asarray(_feats(5, (1, 12, 10, 32))))
    jt = JL.w2_target(m, s)
    tt = TL.w2_target(torch.from_numpy(np.array(m)), torch.from_numpy(np.array(s)))
    assert _rel(tt.cov.numpy(), np.asarray(jt.cov)) < RTOL
    assert _rel(tt.cov_sqrt.numpy(), np.asarray(jt.cov_sqrt)) < 1e-3


@pytest.mark.parametrize("c", [16, 64])
def test_w2_losses_batched_trace_path(c):
    # measured: value <= 1.4e-6, gradient <= 5.6e-6
    g = 2
    style = [_feats(10 + k, (1, 8, 9, c)) for k in range(g)]
    tgts = [JL.w2_target(*JL.w2_moments(jnp.asarray(s))) for s in style]
    jtarget = JL.W2Target(*(jnp.concatenate(f) for f in zip(*tgts)))
    ttarget = TL.W2Target(*(torch.from_numpy(np.array(f)) for f in jtarget))
    w = np.array([0.7, 0.3], np.float32)
    x = np.stack([_feats(20 + k, (1, 10, 9, c))[0] for k in range(g)])

    def jloss(v):
        m, s = JL.w2_moments(v)
        losses = JL.w2_losses_batched(m, JL.moments_to_cov(m, s), jtarget,
                                      trace_sqrtm_fn=j_trace_sqrtm)
        return jnp.sum(losses * w)

    def tloss(v):
        m, s = TL.w2_moments(v)
        covs = TL.moments_to_cov(m, s)
        tr = t_trace_sqrtm(TL.w2_inner(covs, ttarget), 12)
        losses = TL.w2_losses_from_trace(m, covs, ttarget, tr)
        return torch.sum(losses * torch.from_numpy(w))

    _check(jloss, tloss, x)


def test_w2_loss_lyap_path():
    # The full-matrix path with the Lyapunov backward (plain PyTorch in the
    # port). measured: value 3.2e-7, gradient 1.5e-6
    s = _feats(30, (1, 8, 8, 16))
    jt = JL.w2_target(*JL.w2_moments(jnp.asarray(s)))
    tt = TL.W2Target(*(torch.from_numpy(np.array(f)) for f in jt))
    _check(lambda v: JL.w2_loss(v, jt), lambda v: TL.w2_loss(v, tt), _feats(31))


def test_tv_loss():
    # measured: value 6.5e-8, gradient 4.5e-9
    img = np.random.RandomState(7).rand(1, 7, 9, 3).astype(np.float32)
    _check(JL.tv_loss, TL.tv_loss, img)


def _tap(seed, fmt, dtype):
    """A post-ReLU-like (1, 16, 9, 11) tap in memory format ``fmt``."""
    return _nchw(_feats(seed, (1, 9, 11, 16))).to(dtype).contiguous(memory_format=fmt)


def _moments_and_grad(tap, mean):
    """``_moments``' two outputs and the tap's gradient under fixed
    seeded output gradients."""
    rng = np.random.RandomState(40)
    g1 = torch.from_numpy(rng.normal(size=(1, 16)).astype(np.float32))
    g2 = torch.from_numpy(rng.normal(size=(1, 16, 16)).astype(np.float32))
    f = tap.detach().requires_grad_(True)
    first, second = TL._moments(f, mean)
    (g,) = torch.autograd.grad((first * g1).sum() + (second * g2).sum(), f)
    return first.detach(), second.detach(), g, (g1, g2)


@pytest.mark.parametrize("mean", [True, False], ids=["mean", "sum"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_moments_of_a_channels_last_tap(dtype, mean):
    """A channels_last tap's moments, taken as (N, P, C) with no copy, equal
    the NCHW tap's (N, C, P) ones (rtol 1e-6; the same FP32 products summed
    in another order), and its gradient comes back channels_last in the
    tap's dtype (FP32 to rtol 1e-6; bf16 within one bf16 rounding of the
    gradient's max)."""
    cl = _moments_and_grad(_tap(41, torch.channels_last, dtype), mean)
    nchw = _moments_and_grad(_tap(41, torch.contiguous_format, dtype), mean)
    for a, b in zip(cl[:2], nchw[:2]):
        assert a.dtype == torch.float32
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6, atol=0)
    g, ref = cl[2], nchw[2]
    assert g.dtype == dtype and ref.is_contiguous()
    assert g.is_contiguous(memory_format=torch.channels_last) and not g.is_contiguous()
    if dtype == torch.float32:
        np.testing.assert_allclose(g.numpy(), ref.numpy(), rtol=1e-6,
                                   atol=1e-6 * float(ref.abs().max()))
    else:
        err = float((g.float() - ref.float()).abs().max())
        assert err <= 2**-8 * float(ref.float().abs().max()), err


def test_moments_of_an_nchw_tap_are_unchanged():
    """The NCHW tap's path (every FP32 and sharded tap) is the (N, C, P)
    one bit for bit: the mean, f fᵀ, and the backward (G₂ + G₂ᵀ) f plus the
    spread mean gradient, as those ops compute them."""
    tap = _tap(42, torch.contiguous_format, torch.float32)
    first, second, g, (g1, g2) = _moments_and_grad(tap, True)
    f = tap.flatten(2)
    assert torch.equal(first, torch.mean(f, dim=2))
    assert torch.equal(second, f @ f.transpose(1, 2))
    want = (g2 + g2.transpose(1, 2)) @ f
    want.add_((g1 / f.shape[-1]).unsqueeze(-1))
    assert torch.equal(g, want.view_as(tap))
