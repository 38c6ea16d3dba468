"""PyTorch port: the reference-flavour L-BFGS (``--optimizer lbfgs``).

The port's tensor L-BFGS (``step.lbfgs_init``/``lbfgs_step``) is held against
``torch.optim.LBFGS(max_iter=1, history_size=m)`` and against the JAX
package's ``lbfgs_step`` on a toy problem, and the engine's L-BFGS pyramid
against the JAX engine's.
"""

import contextlib
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu import step as JSTEP
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch import engine as TE
from style_transfer_tpu_torch import step as S
from style_transfer_tpu_torch.utils.ema import ema_init

torch.set_num_threads(2)

PARAMS = random_params(0)


def _problem(n=40, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(n, n).astype(np.float32)
    a = (q @ q.T / n + np.eye(n, dtype=np.float32)).astype(np.float32)
    b = rng.randn(n).astype(np.float32)
    x0 = rng.randn(n).astype(np.float32)
    return a, b, x0


def _optim_trajectory(a, b, x0, iters, history_size):
    """torch.optim.LBFGS in the reference's configuration: the oracle."""
    at, bt = torch.tensor(a), torch.tensor(b)
    x = torch.tensor(x0.copy(), requires_grad=True)
    opt = torch.optim.LBFGS([x], lr=1.0, max_iter=1, history_size=history_size)
    losses = []

    def closure():
        opt.zero_grad()
        loss = 0.5 * x @ at @ x - bt @ x + 0.01 * torch.sum(x**4)
        loss.backward()
        return loss

    for _ in range(iters):
        losses.append(float(opt.step(closure).detach()))
    return np.asarray(losses), x.detach().numpy()


def _port_trajectory(a, b, x0, iters, history_size):
    at, bt = torch.tensor(a), torch.tensor(b)
    x = torch.tensor(x0.copy())
    state = S.lbfgs_init(x, memory_size=history_size)
    losses = []
    for _ in range(iters):
        xv = x.detach().requires_grad_(True)
        loss = 0.5 * xv @ at @ xv - bt @ xv + 0.01 * torch.sum(xv**4)
        (g,) = torch.autograd.grad(loss, xv)
        losses.append(float(loss.detach()))
        x, state = S.lbfgs_step(state, x, g, lr=1.0)
    return np.asarray(losses), x.numpy(), state


def _jax_trajectory(a, b, x0, iters, history_size):
    aj, bj = jnp.asarray(a), jnp.asarray(b)

    def f(x):
        return 0.5 * x @ aj @ x - bj @ x + 0.01 * jnp.sum(x**4)

    vg = jax.jit(jax.value_and_grad(f))
    step = jax.jit(lambda s, x, g: JSTEP.lbfgs_step(s, x, g, lr=1.0))
    x = jnp.asarray(x0)
    state = JSTEP.lbfgs_init(x, memory_size=history_size)
    losses = []
    for _ in range(iters):
        loss, g = vg(x)
        losses.append(float(loss))
        x, state = step(state, x, g)
    return np.asarray(losses), np.asarray(x)


@pytest.mark.parametrize("n,seed,iters,history", [
    (40, 0, 30, 10),  # the reference's history of 10
    (24, 3, 25, 4),   # past the history: the circular buffer wraps around
], ids=["history10", "wraparound"])
def test_matches_torch_lbfgs_and_jax(n, seed, iters, history):
    a, b, x0 = _problem(n, seed)
    o_losses, o_x = _optim_trajectory(a, b, x0, iters, history)
    j_losses, j_x = _jax_trajectory(a, b, x0, iters, history)
    t_losses, t_x, state = _port_trajectory(a, b, x0, iters, history)
    # The limits of the JAX package's own test against torch.optim.LBFGS
    # (the same algorithm in FP32): losses rtol 2e-4, x rtol 2e-3 (measured
    # against torch.optim 2.4e-7 and 2.1e-5, against JAX 9.5e-7 and 1.5e-5).
    for ref_losses, ref_x in ((o_losses, o_x), (j_losses, j_x)):
        np.testing.assert_allclose(t_losses, ref_losses, rtol=2e-4, atol=1e-5)
        np.testing.assert_allclose(t_x, ref_x, rtol=2e-3, atol=2e-4)
    assert t_losses[-1] < t_losses[0] - 1.0
    assert int(state.n_iter) == iters and int(state.num_old) == history
    assert state.s_hist.shape == (history, n) and state.rho.dtype == torch.float32


def test_first_step_length_rule():
    """The first step is min(1, 1/|g|_1) * lr along -g."""
    x0 = torch.tensor([3.0, -4.0])
    x1, state = S.lbfgs_step(S.lbfgs_init(x0), x0, x0.clone(), lr=1.0)
    t_expected = min(1.0, 1.0 / (3.0 + 4.0))
    np.testing.assert_allclose(x1.numpy(), (x0 - t_expected * x0).numpy(), rtol=1e-6)
    assert int(state.n_iter) == 1 and int(state.num_old) == 0


def _engine_losses(optimizer="lbfgs", noise=0.0, **kw):
    """The port's pyramid losses; ``noise`` multiplies every gradient the
    L-BFGS step sees by (1 + noise * N(0, 1)), a perturbation at the size
    of float32 rounding."""
    gen = torch.Generator().manual_seed(0)
    step = S.lbfgs_step

    def perturbed(state, image, g, lr, mesh=None):
        g = g * (1 + noise * torch.randn(g.shape, generator=gen))
        return step(state, image, g, lr, mesh)

    st = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=5)
    its = []
    try:
        if noise:
            S.lbfgs_step = perturbed
        with contextlib.redirect_stdout(io.StringIO()):
            st.stylize(kw.pop("content"), kw.pop("styles"), optimizer=optimizer,
                       callback=its.append, **kw)
    finally:
        S.lbfgs_step = step
    return np.asarray([i.loss for i in its]), st


# From the gray init, because the trajectory from the content init is not
# determined to float32 precision: multiplying the port's own gradient by
# (1 + 1e-7 N(0, 1)) moves the loss of its 8th iteration by 40% (a step of
# lr=1 overshoots after the first curvature pair, whose y = g1 - g0 is the
# difference of two nearly equal gradients); from the gray init the same
# perturbation moves the losses by 5.5e-7 of the largest.
PYRAMID = dict(min_scale=48, end_scale=68, iterations=5, initial_iterations=5,
               init="gray")


def test_engine_lbfgs_matches_jax(content_pil, style_pil):
    jst = J.StyleTransfer(devices=1, weights=PARAMS, compute_dtype="float32",
                          sqrtm_impl="xla", w2_grad="trace", callback_chunk=5)
    j_its = []
    jst.stylize(content_pil, [style_pil], optimizer="lbfgs",
                callback=j_its.append, **PYRAMID)
    t_losses, tst = _engine_losses(content=content_pil, styles=[style_pil], **PYRAMID)
    assert len(t_losses) == len(j_its) == 10
    # The JAX package's bar against its torch trajectory, rtol 2e-3
    # (measured 1.2e-6).
    np.testing.assert_allclose(t_losses, [i.loss for i in j_its], rtol=2e-3)
    assert tst.get_image_tensor().shape == jst.get_image_tensor().shape == (51, 68, 3)


def test_engine_lbfgs_trajectory_is_well_conditioned(content_pil, style_pil):
    """The comparison above means something: the trajectory it follows
    does not part under float32-sized gradient noise."""
    base, _ = _engine_losses(content=content_pil, styles=[style_pil], **PYRAMID)
    pert, _ = _engine_losses(noise=1e-7, content=content_pil, styles=[style_pil],
                             **PYRAMID)
    assert np.abs(pert - base).max() / np.abs(base).max() < 1e-4  # measured 5.5e-7


def test_lbfgs_iterate_is_not_clamped(content_pil, style_pil):
    """Within a scale the L-BFGS iterate leaves [0, 1] and stays there: the
    runner applies the step and nothing else (the reference clamps only
    under Adam)."""
    st = T.StyleTransfer(device="cpu", weights=PARAMS)
    cfg = S.StepConfig()
    image = TE._pil_to_nchw(content_pil, (48, 36))
    with contextlib.redirect_stdout(io.StringIO()):
        consts = st._capture_targets(TE._pil_to_nchw(content_pil, (48, 36)),
                                     [style_pil], [1.0], 48, 1.0, None, cfg)
    n = 6
    state = S.LoopState(image=image, opt=S.lbfgs_init(image),
                        ema=ema_init(image, cfg.avg_decay))
    state, losses = S.make_lbfgs_runner(cfg)(st.params, consts, state, n)
    assert state.image.min() < 0.0 or state.image.max() > 1.0
    # The same steps by hand, with no clamp: the same iterate, bit for bit.
    loss_fn = S.build_loss_fn(cfg)
    x, opt = image, S.lbfgs_init(image)
    for k in range(n):
        xv = x.detach().requires_grad_(True)
        loss = loss_fn(xv, st.params, consts)
        (g,) = torch.autograd.grad(loss, xv)
        assert loss.item() == losses[k].item()
        x, opt = S.lbfgs_step(opt, x, g, lr=1.0)
    assert torch.equal(state.image, x)
