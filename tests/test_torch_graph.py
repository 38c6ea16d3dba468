"""PyTorch port: the runners' in-place step body and what the card's CUDA
graphs of it rely on, on the CPU.

On the card, ``step._Runner`` replays one captured CUDA graph of the step
per scale; on the CPU the same in-place body runs eagerly, and that is what
is held here against the JAX package's compiled runners. The engine's
two places that relied on fresh tensors every step are held too: the
checkpoint snapshot (copied at submit) and the memoized host image (keyed
on a count of chunks). Against the engine of 7fa83c3 with these runners,
``test_checkpoint_holds_its_chunk`` and ``test_image_changes_every_chunk``
fail: the writer saved the next chunk's image, and ``get_image`` kept the
first chunk's.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from style_transfer_tpu import step as JSTEP
from style_transfer_tpu.models.vgg import extract_features as jax_features
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.utils.ema import ema_init as jax_ema_init
from style_transfer_tpu_torch import StyleTransfer
from style_transfer_tpu_torch import step as S
from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K
from style_transfer_tpu_torch.parallel import checks
from style_transfer_tpu_torch.parallel.mesh import Mesh
from style_transfer_tpu_torch.utils import checkpoint as ckmod

torch.set_num_threads(2)

ITERS = 10
HW = (48, 64)  # the 64 px canvas of a 4:3 content
# The trunk to layer 11: the style taps at C = 64, 128 and 256 (their
# reference weights, renormed) and the content at 11. The deeper trunk and
# the C = 512 pair would triple the file's time (the JAX compiles and the
# plain NS chains on both sides) and exercise nothing of the body.
CFG = {"content_layers": (11,), "style_layers": (1, 6, 11),
       "style_layer_weights": (256 / 336, 64 / 336, 16 / 336)}


def _problem(optimizer):
    """The seeded (image, content, style) NHWC arrays of
    ``parallel/checks.problem``; L-BFGS from the gray init (from the content
    init its trajectory is not determined to float32, ROADMAP C)."""
    spec = {"hw": HW, "seed": 3, "init": "gray" if optimizer == "lbfgs" else None}
    return checks.problem(spec)


def _jax_losses(optimizer, w2_grad):
    image, content, style = (jnp.asarray(a) for a in _problem(optimizer))
    params = {k: jnp.asarray(v) for k, v in random_params(0).items()}
    cfg = JSTEP.StepConfig(compute_dtype=None, w2_grad=w2_grad, **CFG)
    cf = jax_features(params, content, cfg.content_layers)
    sf = jax_features(params, style, cfg.style_layers)
    consts = {"content": {l: cf[l] for l in cfg.content_layers},
              "style": {l: JL.w2_target(*JL.w2_moments(sf[l])) for l in cfg.style_layers}}
    if optimizer == "adam":
        run, opt = JSTEP.make_adam_runner(cfg), JSTEP.adam_init(image)
    else:
        run, init = JSTEP.make_lbfgs_runner(cfg)
        opt = init(image, params, consts)
    state = JSTEP.LoopState(image=image, opt=opt, ema=jax_ema_init(image, cfg.avg_decay))
    _, losses = run(params, consts, state, ITERS)
    return np.asarray(losses)


def _port_problem(optimizer, w2_grad):
    """The port's runner, params, consts and initial state on the same
    arrays (``parallel/checks.run``'s construction, NCHW)."""
    from style_transfer_tpu_torch.models.vgg import extract_features
    from style_transfer_tpu_torch.models.weights import params_from_jax
    from style_transfer_tpu_torch.ops import losses as L
    from style_transfer_tpu_torch.utils.ema import ema_init

    cfg = S.StepConfig(w2_grad=w2_grad, **CFG)
    params = params_from_jax(random_params(0), "cpu")
    image, content, style = (torch.from_numpy(a).permute(0, 3, 1, 2).contiguous()
                             for a in _problem(optimizer))
    with torch.no_grad():
        cf = extract_features(params, content, cfg.content_layers)
        sf = extract_features(params, style, cfg.style_layers)
    consts = {"content": {l: cf[l] for l in cfg.content_layers},
              "style": {l: L.w2_target(*L.w2_moments(sf[l])) for l in cfg.style_layers}}
    spec = S.OPTIMIZERS[optimizer]
    state = S.LoopState(image=image, opt=spec.init(image), ema=ema_init(image, cfg.avg_decay))
    return spec.runner(cfg), params, consts, state


@pytest.mark.parametrize("w2_grad", ["trace", "lyap"])
@pytest.mark.parametrize("optimizer", ["adam", "lbfgs"])
def test_in_place_body_matches_jax_runner(optimizer, w2_grad):
    """The in-place step body, run 10 times by the runner (eagerly on the
    CPU), against the JAX package's jitted ``lax.scan`` runner on the same
    seeded inputs and weights: losses to rtol 2e-3, the bar of
    tests/test_fullloop_torch.py."""
    run, params, consts, state = _port_problem(optimizer, w2_grad)
    _, losses = run(params, consts, state, ITERS)
    np.testing.assert_allclose(losses.numpy(), _jax_losses(optimizer, w2_grad), rtol=2e-3)


def _ulps(a, b):
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))


def test_adam_bias_correction_on_device_matches_jax():
    """The bias corrections from the float32 device count against the
    expression of the JAX package's ``_adam_apply`` (1 - beta^t with t the
    count in float32), for counts 1-10 000: within 1 ulp of float32. Then
    the whole update against JAX's ``_adam_apply`` at those counts: the
    moments and the count exact, the update within 2 ulp, which ATen's CPU
    ``sqrt`` alone accounts for (it rounds 1 ulp from the IEEE square root
    that numpy and XLA take, and the division after it doubles that)."""
    cfg, jcfg = S.StepConfig(), JSTEP.StepConfig()
    t = np.arange(1, 10001, dtype=np.float32)
    bc1, bc2 = S.adam_bias_corrections(cfg, torch.from_numpy(t))
    jbc = jax.jit(lambda t: (1.0 - jnp.power(jcfg.beta1, t), 1.0 - jnp.power(jcfg.beta2, t)))
    jbc1, jbc2 = (np.asarray(b) for b in jbc(jnp.asarray(t)))
    assert bc1.dtype == bc2.dtype == torch.float32
    assert _ulps(bc1.numpy(), jbc1).max() <= 1
    assert _ulps(bc2.numpy(), jbc2).max() <= 1

    rng = np.random.RandomState(0)
    mu, g = rng.randn(2, 16).astype(np.float32)
    nu = np.abs(rng.randn(16)).astype(np.float32)
    counts = np.arange(10000, dtype=np.int32)  # before the update: t = 1..10000
    japply = jax.jit(jax.vmap(lambda c: JSTEP._adam_apply(
        jcfg, JSTEP.AdamState(jnp.asarray(mu), jnp.asarray(nu), c), jnp.asarray(g))))
    jupdate, jopt = japply(jnp.asarray(counts))
    update, opt = S._adam_apply(
        cfg, S.AdamState(torch.from_numpy(mu), torch.from_numpy(nu),
                         torch.from_numpy(counts.astype(np.float32))[:, None]),
        torch.from_numpy(g))
    np.testing.assert_array_equal(opt.mu.numpy(), np.asarray(jopt.mu)[0])
    np.testing.assert_array_equal(opt.nu.numpy(), np.asarray(jopt.nu)[0])
    np.testing.assert_array_equal(opt.count.numpy()[:, 0], np.asarray(jopt.count))
    assert _ulps(update.numpy(), np.asarray(jupdate)).max() <= 2


def test_runner_keeps_its_own_buffers():
    """The runner copies the caller's state into buffers of its own and
    never writes the caller's tensors; the state it hands back continues
    where it stopped (3 + 7 iterations equal 10, bit for bit), with Adam's
    host count advanced by each chunk."""
    run, params, consts, state = _port_problem("adam", "trace")
    before = [t.clone() for t in (state.image, state.opt.mu, state.ema.value)]
    one, losses = run(params, consts, state, ITERS)
    for t, b in zip((state.image, state.opt.mu, state.ema.value), before):
        assert torch.equal(t, b)
    assert one.opt.count == ITERS
    one = [t.clone() for t in (one.image, one.opt.mu, one.opt.nu, *one.ema)]
    mid, first = run(params, consts, state, 3)
    end, rest = run(params, consts, mid, 7)
    assert end.opt.count == ITERS
    assert end.image is mid.image  # the same buffers, written in place
    assert torch.equal(torch.cat([first, rest]), losses)
    for a, b in zip((end.image, end.opt.mu, end.opt.nu, *end.ema), one):
        assert torch.equal(a, b)


def test_adam_carry_matches_jax_scale_adam():
    """``OPTIMIZERS['adam'].carry``, the moments taken into the next scale,
    against the JAX engine's ``_scale_adam`` on the same moments across a
    sqrt(2) crossing (36x48 -> 51x68): the first moment bicubic, the second
    bilinear and clamped at 0 (here it has negative entries, so the clamp
    acts), the count kept as the host's int. JAX resizes by dense FP32
    weight matrices, the port by ``F.interpolate``: within 1e-5 of each
    moment's max (measured 3.6e-6 and 3.4e-6)."""
    from style_transfer_tpu.engine import _scale_adam as jax_scale_adam

    rng = np.random.RandomState(11)
    mu, nu = rng.randn(2, 1, 36, 48, 3).astype(np.float32)
    out = S.OPTIMIZERS["adam"].carry(
        S.AdamState(*(torch.from_numpy(a).permute(0, 3, 1, 2) for a in (mu, nu)), 17),
        (51, 68))
    ref = jax_scale_adam(JSTEP.AdamState(jnp.asarray(mu), jnp.asarray(nu), 17), (51, 68))
    assert out.count == 17 and isinstance(out.count, int)
    assert float(out.nu.min()) == 0.0
    for got, want in ((out.mu, ref.mu), (out.nu, ref.nu)):
        want = np.asarray(want)
        assert got.shape == (1, 3, 51, 68)
        err = np.abs(got.permute(0, 2, 3, 1).numpy() - want).max() / np.abs(want).max()
        assert err < 1e-5


def _stylize(st, content, style, **kw):
    st.stylize(content, [style], min_scale=64, end_scale=64, iterations=10,
               initial_iterations=10, **kw)


def _images():
    rng = np.random.RandomState(5)
    content = Image.fromarray((rng.rand(48, 64, 3) * 255).astype(np.uint8))
    style = Image.fromarray((rng.rand(64, 64, 3) * 255).astype(np.uint8))
    return content, style


def test_checkpoint_holds_its_chunk(tmp_path, monkeypatch):
    """A checkpoint submitted after chunk 1 is written only after chunk 2
    has run (the writer is held until then) and still holds chunk 1's
    image and EMA: the engine copies the state at submit, since the
    runners write it in place."""
    content, style = _images()
    release, saved, at_chunk1 = threading.Event(), [], {}
    save = ckmod.save_checkpoint

    def held_save(path, **kw):
        if not saved:
            release.wait(timeout=60)
        saved.append((np.array(kw["image"]), np.array(kw["ema"].value), kw["done_iters"]))
        save(path, **kw)

    monkeypatch.setattr(ckmod, "save_checkpoint", held_save)
    st = StyleTransfer(device="cpu", weights=random_params(0), callback_chunk=5)

    def callback(it):
        if it.i == 5:
            at_chunk1["image"] = st.image.permute(0, 2, 3, 1).numpy().copy()
            at_chunk1["ema"] = st.average.value.permute(0, 2, 3, 1).numpy().copy()
        if it.i == 10:
            release.set()

    _stylize(st, content, style, callback=callback, checkpoint=str(tmp_path / "ck.npz"),
             checkpoint_every=5)
    assert release.is_set() and [s[2] for s in saved] == [5, 10]
    image, ema, _ = saved[0]
    np.testing.assert_array_equal(image, at_chunk1["image"])
    np.testing.assert_array_equal(ema, at_chunk1["ema"])
    assert not np.array_equal(saved[1][0], image)


def test_image_changes_every_chunk():
    """``get_image`` read after chunk 2 differs from its read after chunk 1,
    though the EMA state is the same tensors: the memo is keyed on the
    chunk, not on the state object."""
    content, style = _images()
    st = StyleTransfer(device="cpu", weights=random_params(0), callback_chunk=5)
    seen = {}

    def callback(it):
        if it.i in (5, 10):
            seen[it.i] = np.asarray(st.get_image(), dtype=np.int16)

    _stylize(st, content, style, callback=callback)
    assert np.abs(seen[10] - seen[5]).max() > 0


@pytest.mark.parametrize("device,optimizer,mesh,graph", [
    ("cuda:0", "adam", None, True),
    ("cuda:0", "lbfgs", None, True),
    (torch.device("cuda", 1), "adam", None, True),
    ("cuda:0", "lbfgs-zoom", None, True),
    ("cuda:0", "adam", "mesh", False),
    ("cuda:0", "lbfgs", "mesh", False),
    ("cuda:0", "lbfgs-zoom", "mesh", False),
    ("cpu", "adam", None, False),
    ("cpu", "lbfgs", None, False),
    ("cpu", "lbfgs-zoom", None, False),
])
def test_path_choice(device, optimizer, mesh, graph):
    """Graph replays on a CUDA device with no mesh, for the runner of every
    entry of ``OPTIMIZERS`` (the zoom L-BFGS's iteration as three graphs);
    a mesh and the CPU run eagerly, and so does a runner asked for
    ``eager``."""
    mesh = None if mesh is None else Mesh(grid=(2, 1), rank=0, device=torch.device("cpu"))
    make = S.OPTIMIZERS[optimizer].runner
    assert make(S.StepConfig(), mesh).graphed(torch.device(device)) is graph
    assert make(S.StepConfig(), mesh, eager=True).graphed(torch.device(device)) is False


def test_launch_counts_add_per_replay():
    """What a capture recorded moves from the capture to the replays: the
    counts after a capture and n replays are the start plus n times it."""
    start = K.launch_counts()
    try:
        recorded = (4, 0, 0)
        K.add_launches(recorded)  # the capture's wrapper calls
        K.add_launches(recorded, -1)  # taken back: the capture ran nothing
        for _ in range(3):
            K.add_launches(recorded)
        assert K.launch_counts() == (start[0] + 12, start[1], start[2])
    finally:
        K.add_launches(tuple(s - c for s, c in zip(start, K.launch_counts())))
    assert K.launch_counts() == start
