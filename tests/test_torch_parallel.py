"""PyTorch port: spatial sharding (``parallel/mesh.py``) against the JAX
package's mesh and against the one-device port, on the CPU.

The sharded runs are real: 2 and 4 gloo ranks started by
``parallel.launch.launch``, each running ``parallel.checks.run`` on its slab
(halo-exchanged convs and TV, all-reduced moments and L-BFGS reductions).
One launch of each size serves every case of this file. The JAX side runs
on ``jax.devices()[:n]`` of the conftest's eight CPU devices.
"""

import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu.models.vgg import extract_features as jax_features
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.parallel import mesh as JM
from style_transfer_tpu.utils import scales as JS
from style_transfer_tpu.utils.ema import ema_init as jax_ema_init
from style_transfer_tpu_torch.parallel import checks
from style_transfer_tpu_torch.parallel import mesh as TM
from style_transfer_tpu_torch.parallel.launch import launch
from style_transfer_tpu_torch.utils import scales as TS

torch.set_num_threads(2)

# BASELINE.json's sizes: the 256 px scale, the 128 -> 512 pyramid, and
# the print sizes 1448x1086 and 2896x2172; odd sizes beside them.
SIZES = [(256, 192), (128, 96), (181, 136), (256, 192), (362, 272), (512, 384),
         (1448, 1086), (2896, 2172), (67, 50), (96, 72), (1000, 667)]

# One 2-rank launch runs every spec below; FOUR_RANK_SPECS one 4-rank one.
EVAL = {"hw": (64, 96), "steps": 8}
VARIANTS = {
    "max": EVAL,
    "average": {"hw": (64, 96), "cfg": {"pooling": "average"}},
    "l2": {"hw": (64, 96), "cfg": {"pooling": "l2"}},
    "gram": {"hw": (64, 96), "cfg": {"style_loss": "gram"}},
    "scaled": {"hw": (64, 96), "cfg": {"content_loss": "scaled"}},
    "remat": {"hw": (64, 96), "cfg": {"remat": True}},
}
# 72 rows: shard_align_size keeps 72 (64 and 96 are over 1.5% away), so
# the two slabs are 32 and 40 rows.
UNEVEN = {"hw": (72, 96)}
LBFGS = {"hw": (64, 96), "cfg": {"w2_grad": "lyap"}, "optimizer": "lbfgs",
         "init": "gray", "steps": 5}
# 24 rows cannot give two ranks 16 each: every rank runs the whole image.
SMALL = {"hw": (24, 40), "steps": 2}
TWO_RANK_SPECS = [*VARIANTS.values(), UNEVEN, LBFGS, SMALL]
FOUR_RANK_SPECS = [{"hw": (64, 96)}, {"hw": (67, 50)}]


def _launch(specs, world):
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        launch(checks.run_ranks, ["cpu"] * world, (specs, tmp), timeout_s=300)
        secs = time.perf_counter() - t0
        out = [[dict(np.load(f"{tmp}/spec{i}_rank{r}.npz")) for r in range(world)]
               for i in range(len(specs))]
    return out, secs


@pytest.fixture(scope="module")
def two_ranks():
    out, secs = _launch(TWO_RANK_SPECS, 2)
    print(f"2-rank launch: {secs:.1f} s")
    return {id(spec): ranks for spec, ranks in zip(TWO_RANK_SPECS, out)}


@pytest.fixture(scope="module")
def four_ranks():
    out, _ = _launch(FOUR_RANK_SPECS, 4)
    return out


def _check_against_unsharded(ranks, spec, grad_tol=1e-4):
    """Per-rank losses bit-identical; against the one-device port the loss
    to rtol 1e-5, each weighted term of ``build_loss_terms_fn`` to 1e-5 of
    the loss (a W2 term is a difference of traces, so its own relative
    error is larger) and the gathered gradient to ``grad_tol`` of its max."""
    ref = checks.run(spec)
    for r in ranks[1:]:
        assert r["loss"] == ranks[0]["loss"]
        np.testing.assert_array_equal(r["terms"], ranks[0]["terms"])
        np.testing.assert_array_equal(r["grad"], ranks[0]["grad"])
    np.testing.assert_allclose(ranks[0]["loss"], ref["loss"], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["terms"], ref["terms"], rtol=0,
                               atol=1e-5 * abs(float(ref["loss"])))
    err = np.abs(ranks[0]["grad"] - ref["grad"]).max() / np.abs(ref["grad"]).max()
    assert err < grad_tol, err
    return ref


@pytest.mark.parametrize("n", range(1, 9))
def test_factor_devices_and_shard_align_match_jax(n):
    assert TM.factor_devices(n) == JM.factor_devices(n)
    rows, cols = TM.factor_devices(n)
    for size in SIZES:
        assert TS.shard_align_size(size, rows, cols) == JS.shard_align_size(size, rows, cols)


def test_slab_bounds():
    mesh = TM.Mesh(grid=(2, 2), rank=3, device=torch.device("cpu"))
    # Interior edges on multiples of 16; the last slab takes the remainder.
    assert TM.slab_bounds(72, 96, mesh) == ((32, 72), (48, 96))
    assert TM.slab_bounds(72, 96, mesh, (0, 0)) == ((0, 32), (0, 48))
    assert TM._splits(1086, 2) == [0, 544, 1086]
    assert TM._splits(50, 2) == [0, 32, 50]
    assert mesh.on_canvas(72, 96).canvas == (72, 96)
    # Too small to give each rank 16 rows (or columns): not sharded.
    assert mesh.on_canvas(31, 96) is None and mesh.on_canvas(72, 31) is None
    with pytest.raises(ValueError, match="too small"):
        TM.slab_bounds(31, 96, mesh)
    # Each slab floor-halves through the four pools as the whole image
    # does, so the local activation finds its global size.
    placed = mesh.on_canvas(72, 98)
    for k in range(5):
        local = torch.zeros(1, 1, (72 >> k) - (32 >> k), (98 >> k) - (48 >> k))
        assert placed.global_hw(local) == (72 >> k, 98 >> k)


@pytest.mark.parametrize("n", [2, 4], ids=["2x1", "2x2"])
def test_canvas_under_mesh_matches_jax_engine(n):
    params = random_params(0)
    jst = J.StyleTransfer(devices=jax.devices()[:n], weights=params,
                          compute_dtype="float32")
    mesh = TM.Mesh(grid=TM.factor_devices(n), rank=0, device=torch.device("cpu"))
    tst = T.StyleTransfer(weights=params, mesh=mesh)
    assert tst.device == torch.device("cpu")
    for content_size in [(640, 480), (1448, 1086), (97, 131), (4000, 3000)]:
        for scale in [64, 128, 181, 256, 362, 512, 1024, 1448, 2896]:
            for align in (None, 1, 8):
                assert tst.canvas(content_size, scale, align) == jst.canvas(
                    content_size, scale, align)


def _jax_mesh_run(spec, n_devices, steps):
    """The JAX package's sharded gradient (``build_loss_fn(cfg, mesh)``) and
    its ``make_adam_runner(cfg, mesh)`` losses on the same problem, NHWC."""
    from style_transfer_tpu import step as JSTEP

    image, content, style = (jnp.asarray(a) for a in checks.problem(spec))
    params = {k: jnp.asarray(v) for k, v in random_params(0).items()}
    cfg = JSTEP.StepConfig(compute_dtype=None)
    cf = jax_features(params, content, cfg.content_layers)
    sf = jax_features(params, style, cfg.style_layers)
    consts = {"content": {l: cf[l] for l in cfg.content_layers},
              "style": {l: JL.w2_target(*JL.w2_moments(sf[l])) for l in cfg.style_layers}}
    mesh = JM.make_mesh(jax.devices()[:n_devices])
    x = JM.shard_image(image, mesh)
    grad = jax.jit(jax.grad(JSTEP.build_loss_fn(cfg, mesh)))(x, params, consts)
    state = JSTEP.LoopState(image=x, opt=JSTEP.adam_init(x), ema=jax_ema_init(x, 0.99))
    _, losses = JSTEP.make_adam_runner(cfg, mesh)(params, consts, state, steps)
    return np.asarray(grad), np.asarray(losses)


def test_two_ranks_match_jax_two_device_mesh(two_ranks):
    """One evaluation and 8 Adam iterations on 2 ranks (2x1) against the
    JAX package's 2-device mesh: the loss at the image to rtol 1e-5, the
    gathered gradient to 1e-4 of its max, the iterations' losses to rtol
    2e-3 (the established bar against JAX, tests/test_fullloop_torch.py)
    and the per-rank losses bit-identical."""
    ranks = two_ranks[id(EVAL)]
    grad, losses = _jax_mesh_run(EVAL, 2, 8)
    np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])
    np.testing.assert_allclose(ranks[0]["loss"], losses[0], rtol=1e-5)
    np.testing.assert_allclose(ranks[0]["losses"], losses, rtol=2e-3)
    port = ranks[0]["grad"].transpose(0, 2, 3, 1)
    assert np.abs(port - grad).max() / np.abs(grad).max() < 1e-4


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_sharded_evaluation_matches_unsharded(two_ranks, variant):
    """max, average and L2 pooling, the Gram style loss and ScaledMSE
    content: one evaluation at 64x96 on 2 ranks against the one-device
    port (itself held to the JAX package by test_torch_losses.py and
    test_torch_vgg.py)."""
    _check_against_unsharded(two_ranks[id(VARIANTS[variant])], VARIANTS[variant])


def test_adam_iterations_match_unsharded(two_ranks):
    """Adam's first updates are about lr·sign(g), so rounding flips of
    near-zero gradient components move single pixels (the one-device run
    with 1 thread against its default moves them by up to 3.2e-3): the
    image is held by its mean difference, as tests/test_sharding.py holds
    the JAX package's."""
    ranks = two_ranks[id(EVAL)]
    ref = checks.run(EVAL)
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)
    assert np.abs(ranks[0]["image"] - ref["image"]).mean() < 1e-3


def test_uneven_split_gradient(two_ranks):
    assert TS.shard_align_size((96, 72), 2, 1) == (96, 72)
    assert TM._splits(72, 2) == [0, 32, 72]
    _check_against_unsharded(two_ranks[id(UNEVEN)], UNEVEN)


def test_lbfgs_reductions(two_ranks):
    """The reference L-BFGS with the lyap gradient from the gray init: its
    inner products, l1 and max norms all-reduced, the same steps on every
    rank and on one device. (From the content init the reference L-BFGS is
    not determined to float32 precision; ROADMAP C.)"""
    ranks = two_ranks[id(LBFGS)]
    ref = _check_against_unsharded(ranks, LBFGS)
    np.testing.assert_array_equal(ranks[1]["losses"], ranks[0]["losses"])
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)


def test_too_small_scale_runs_whole_on_every_rank(two_ranks):
    ranks = two_ranks[id(SMALL)]
    ref = _check_against_unsharded(ranks, SMALL)
    np.testing.assert_allclose(ranks[0]["losses"], ref["losses"], rtol=1e-5)


@pytest.mark.parametrize("case", range(len(FOUR_RANK_SPECS)), ids=["64x96", "67x50"])
def test_four_ranks_2x2_grid(four_ranks, case):
    """The W split and the corner halos: 4 ranks on a 2x2 grid, evenly and
    unevenly split (67x50: slabs of 32/35 rows and 32/18 columns)."""
    _check_against_unsharded(four_ranks[case], FOUR_RANK_SPECS[case])
