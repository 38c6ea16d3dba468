"""PyTorch port: Newton-Schulz square roots and the CUDA kernel's wrapper.

The port's plain ``trace_sqrtm_ns`` is held, value and gradient, against the
JAX package's XLA version and against its Pallas kernel run in interpret
mode; the grouped wrapper (``ns_sqrtm_yz_groups``, one launch for every
W2 group on a card), its block planner and the step's W2 term through it
against the per-group calls and the JAX package. The CUDA kernels
themselves run only on the card (``-m cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from style_transfer_tpu.ops import losses as JL
from style_transfer_tpu.ops import sqrtm as JS
from style_transfer_tpu.ops.pallas.ns_sqrtm import trace_sqrtm_ns_pallas
from style_transfer_tpu_torch import step as S
from style_transfer_tpu_torch.bench import build_step
from style_transfer_tpu_torch.ops import losses as TL
from style_transfer_tpu_torch.ops import sqrtm as TS
from style_transfer_tpu_torch.ops.cuda import build
from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K
from style_transfer_tpu_torch.utils import trace as TR

torch.set_num_threads(2)


def _mats(g, n, kind, seed=0):
    """SPD (full rank + 1e-3 I) or rank-deficient (rank n/4) + 1e-4 I."""
    rng = np.random.RandomState(seed)
    r = n if kind == "spd" else n // 4
    eps = 1e-3 if kind == "spd" else 1e-4
    x = rng.randn(g, n, r).astype(np.float32)
    return (x @ x.transpose(0, 2, 1) / n + eps * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


CASES = [(2, 64, "spd"), (1, 128, "spd"), (2, 64, "lowrank"), (1, 128, "lowrank")]


def _port_value_grad(a, w, fn):
    x = torch.from_numpy(a).requires_grad_(True)
    v = fn(x, 12)
    (g,) = torch.autograd.grad((v * torch.from_numpy(w)).sum(), x)
    return v.detach().numpy(), g.numpy()


def _jax_value_grad(a, w, fn):
    val = np.asarray(fn(jnp.asarray(a), 12))
    grad = jax.grad(lambda m: jnp.sum(fn(m, 12) * jnp.asarray(w)))(jnp.asarray(a))
    return val, np.asarray(grad)


def _rel(x, ref):
    return np.abs(x - ref).max() / np.abs(ref).max()


@pytest.mark.parametrize("g,n,kind", CASES)
def test_trace_sqrtm_matches_jax_xla(g, n, kind):
    a = _mats(g, n, kind)
    w = np.random.RandomState(1).randn(g).astype(np.float32)
    tv, tg = _port_value_grad(a, w, TS.trace_sqrtm_ns)
    jv, jg = _jax_value_grad(a, w, JS.trace_sqrtm_ns)
    # Both are FP32 matmul chains of the same iteration, summed in their own
    # order: rtol 1e-4 (measured at most 6.8e-7 on the value and 4.2e-5 on
    # the gradient, both rank-deficient).
    np.testing.assert_allclose(tv, jv, rtol=1e-4)
    assert _rel(tg, jg) < 1e-4


@pytest.mark.parametrize("g,n,kind", CASES)
def test_trace_sqrtm_matches_pallas_interpret(g, n, kind):
    a = _mats(g, n, kind)
    w = np.random.RandomState(2).randn(g).astype(np.float32)
    tv, tg = _port_value_grad(a, w, TS.trace_sqrtm_ns)
    with pltpu.force_tpu_interpret_mode():
        jv, jg = _jax_value_grad(a, w, trace_sqrtm_ns_pallas)
    # The Pallas kernel multiplies in bf16x3 (about 16 mantissa bits), so
    # 5e-3 relative (measured at most 2.7e-5 on the value and 2.2e-3 on the
    # gradient, both rank-deficient, where Z ~ A^{-1/2} is largest).
    assert _rel(tv, jv) < 5e-3
    assert _rel(tg, jg) < 5e-3


def test_dispatching_autograd_matches_plain_on_cpu():
    a = _mats(2, 64, "spd", seed=3)
    w = np.random.RandomState(4).randn(2).astype(np.float32)
    before = K.ns_sqrtm_yz.launches
    pv, pg = _port_value_grad(a, w, TS.trace_sqrtm_ns)
    kv, kg = _port_value_grad(a, w, K.trace_sqrtm_ns)
    np.testing.assert_array_equal(kv, pv)
    np.testing.assert_array_equal(kg, pg)
    assert K.ns_sqrtm_yz.launches == before


def test_wrapper_on_cpu_returns_plain_and_counts_nothing():
    a = torch.from_numpy(_mats(1, 64, "lowrank", seed=5))
    before = K.ns_sqrtm_yz.launches
    y, z = K.ns_sqrtm_yz(a, 12)
    py, pz = K.ns_sqrtm_yz_plain(a, 12)
    assert torch.equal(y, py) and torch.equal(z, pz)
    y2, _ = K.ns_sqrtm_yz(a[0], 12)  # the unbatched form
    assert y2.shape == (64, 64) and torch.equal(y2, py[0])
    assert K.ns_sqrtm_yz.launches == before


def test_groups_on_cpu_equal_the_per_group_calls():
    """On CPU tensors the grouped wrapper takes each group's plain chain:
    each (Y, Z) equals ``ns_sqrtm_yz`` and the plain version bit for bit,
    whatever the groups' shapes (an unbatched one among them), and nothing
    is launched or counted."""
    mats = [torch.from_numpy(_mats(1, 64, "spd", seed=7)),
            torch.from_numpy(_mats(2, 48, "lowrank", seed=8)),
            torch.from_numpy(_mats(1, 100, "spd", seed=9))[0]]
    before, first = K.ns_sqrtm_yz.launches, len(TR.events())
    out = K.ns_sqrtm_yz_groups(mats, 12)
    assert len(out) == 3
    for (y, z), a in zip(out, mats):
        for ref in (K.ns_sqrtm_yz(a, 12), K.ns_sqrtm_yz_plain(a, 12)):
            assert torch.equal(y, ref[0]) and torch.equal(z, ref[1])
        assert y.shape == z.shape == a.shape
    assert K.ns_sqrtm_yz.launches == before
    assert not [e for e in TR.events()[first:] if e.name == "ns-groups"]


def test_grouped_trace_autograd_matches_per_group_on_cpu():
    """``trace_sqrtm_ns_groups``: each group's value and gradient (½·g·Z,
    outside the kernel) equal ``trace_sqrtm_ns`` on that group alone."""
    mats = [_mats(1, 64, "spd", seed=10), _mats(2, 32, "lowrank", seed=11)]
    ws = [np.random.RandomState(12 + k).randn(m.shape[0]).astype(np.float32)
          for k, m in enumerate(mats)]
    xs = [torch.from_numpy(m).requires_grad_(True) for m in mats]
    trs = K.trace_sqrtm_ns_groups(xs, 12)
    grads = torch.autograd.grad(sum((t * torch.from_numpy(w)).sum()
                                    for t, w in zip(trs, ws)), xs)
    for m, w, tr, g in zip(mats, ws, trs, grads):
        v, ref_g = _port_value_grad(m, w, K.trace_sqrtm_ns)
        np.testing.assert_array_equal(tr.detach().numpy(), v)
        np.testing.assert_array_equal(g.numpy(), ref_g)


def test_groups_reject_mixed_devices_and_empty():
    with pytest.raises(ValueError):
        K.ns_sqrtm_yz_groups([], 12)
    with pytest.raises(TypeError):
        K.ns_sqrtm_yz_groups([torch.eye(8), torch.eye(8, dtype=torch.float64)], 12)


MAIN = [(2, 512), (1, 256), (1, 128), (1, 64)]


@pytest.mark.parametrize("shapes,capacity", [
    (MAIN, 396), (MAIN, 264), (MAIN, 132), (MAIN, 40), (MAIN, 4),
    ([(2, 512)], 396), ([(1, 64)], 396), ([(2, 512)], 100),
    ([(1, 100), (1, 300)], 396), ([(3, 200), (1, 512)], 396), ([(3, 200), (1, 512)], 60),
    ([(16, 256), (1, 300), (1, 64)], 396),
])
def test_plan_groups_covers_every_group_within_the_card(shapes, capacity):
    """The planner gives every group at least one block and no group more
    than it can use (a block a tile of an iteration's products), plans no
    more blocks than the card holds resident, and gives every group its
    want when the wants fit (a single group as much of the card as it can
    use)."""
    blocks = K.plan_groups(shapes, capacity)
    gemm = any(c > 256 for _, c in shapes)
    wants = [K._group_work(g, c, gemm)[1] for g, c in shapes]
    assert len(blocks) == len(shapes)
    assert all(1 <= b <= w for b, w in zip(blocks, wants))
    assert sum(blocks) <= capacity
    if sum(wants) <= capacity:
        assert blocks == wants
    else:
        assert sum(blocks) == capacity or blocks == wants


def test_plan_groups_wants_and_refusal():
    """The main path's wants: C = 512 a block for each 64x64 tile of its two
    products (2 x 2 x 64), C <= 256 beside it a block for each 32x32 tile;
    without a C > 256 group a block for each tile of both products; ragged
    C rounds its tiles up; more groups than resident blocks is refused by
    name."""
    assert K.plan_groups(MAIN, 396) == [256, 64, 16, 4]
    assert K.plan_groups([(1, 100), (1, 300)], 396) == [16, 50]
    assert K.plan_groups([(3, 200), (1, 512)], 396) == [147, 128]
    assert K.plan_groups([(1, 256), (1, 128), (1, 64)], 396) == [128, 32, 8]
    assert K.plan_groups([(2, 512)], 396) == [256]
    assert K.plan_groups([(1, 64)], 396) == [8]
    with pytest.raises(K.NSGroupsResidencyError):
        K.plan_groups(MAIN, 3)


def _w2_problem():
    cfg = S.StepConfig(content_layers=(), content_weights=(), tv_weight=0.0)
    _, params, consts, state = build_step(48, 64, device="cpu")
    return cfg, params, consts, state.image


def _loss_and_grad(cfg, params, consts, image):
    x = image.clone().requires_grad_(True)
    loss = S.build_loss_fn(cfg)(x, params, consts)
    (g,) = torch.autograd.grad(loss, x)
    return loss.detach(), g


def test_w2_total_one_grouped_call_matches_per_group_calls(monkeypatch):
    """The step's W2 term makes one grouped call for its four channel
    groups; its loss and image gradient equal those of one call a group
    (the schedule before the grouped launch) bit for bit on the CPU."""
    cfg, params, consts, image = _w2_problem()
    calls = []
    grouped = K.trace_sqrtm_ns_groups

    def counting(mats, n):
        calls.append([tuple(m.shape) for m in mats])
        return grouped(mats, n)

    monkeypatch.setattr(S, "trace_sqrtm_ns_groups", counting)
    loss, grad = _loss_and_grad(cfg, params, consts, image)
    assert calls == [[(1, 64, 64), (1, 128, 128), (1, 256, 256), (2, 512, 512)]]
    monkeypatch.setattr(S, "trace_sqrtm_ns_groups",
                        lambda mats, n: [K.trace_sqrtm_ns(m, n) for m in mats])
    ref_loss, ref_grad = _loss_and_grad(cfg, params, consts, image)
    assert torch.equal(loss, ref_loss) and torch.equal(grad, ref_grad)


def test_w2_total_matches_jax_per_group_losses():
    """The step's W2 term against the JAX package's per-group
    ``w2_losses_batched`` with its trace square root, on the port's own
    moments and targets: rtol 1e-4, ``tests/test_torch_losses.py``'s bar."""
    cfg, params, consts, image = _w2_problem()
    loss, _ = _loss_and_grad(cfg, params, consts, image)
    _, moments = S._features_and_moments(cfg, None, image, params)
    total = 0.0
    for c in sorted({consts["style"][l].mean.shape[-1] for l in cfg.style_layers}):
        layers = [(l, w) for l, w in zip(cfg.style_layers, cfg.style_layer_weights)
                  if consts["style"][l].mean.shape[-1] == c]
        m = jnp.asarray(np.concatenate([moments[l][0].numpy() for l, _ in layers]))
        srm = jnp.asarray(np.concatenate([moments[l][1].numpy() for l, _ in layers]))
        tgt = JL.W2Target(*(jnp.asarray(np.concatenate(
            [getattr(consts["style"][l], f).numpy() for l, _ in layers]))
            for f in ("mean", "cov", "cov_sqrt")))
        losses = JL.w2_losses_batched(m, JL.moments_to_cov(m, srm, cfg.w2_eps), tgt,
                                      cfg.sqrtm_iters, trace_sqrtm_fn=JS.trace_sqrtm_ns)
        total += float(jnp.sum(losses * jnp.asarray([w for _, w in layers])))
    np.testing.assert_allclose(float(loss), total, rtol=1e-4)


@pytest.mark.parametrize("bad,exc", [
    (torch.eye(8, dtype=torch.float64), TypeError),
    (torch.zeros(2, 8, 6), ValueError),
    (torch.zeros(2, 2, 8, 8), ValueError),
    (torch.zeros(8), ValueError),
])
def test_wrapper_rejects_bad_dtype_or_shape(bad, exc):
    with pytest.raises(exc):
        K.ns_sqrtm_yz(bad, 12)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    monkeypatch.setattr("torch.utils.cpp_extension.CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.load(str(tmp_path / "build"))
    assert not (tmp_path / "build").exists() or not any((tmp_path / "build").iterdir())


def test_library_name_tracks_sources(tmp_path):
    p = build.library_path(tmp_path)
    assert p.parent == tmp_path and p.name.startswith("libstt_kernels_")
    assert p == build.library_path(tmp_path)


def test_library_name_tracks_headers(tmp_path, monkeypatch):
    """A change to a csrc/ header alone gives the library a new name, so a
    stale build is never loaded."""
    csrc = tmp_path / "csrc"
    csrc.mkdir()
    (csrc / "k.cu").write_text('#include "k.cuh"\n')
    (csrc / "k.cuh").write_text("constexpr int kA = 1;\n")
    monkeypatch.setattr(build, "CSRC_DIR", csrc)
    before = build.library_path(tmp_path)
    (csrc / "k.cuh").write_text("constexpr int kA = 2;\n")
    assert build.library_path(tmp_path) != before


@pytest.mark.cuda
@pytest.mark.parametrize("g,n", [(1, 64), (1, 100), (1, 256), (1, 300), (2, 512)])
def test_kernel_matches_plain_on_card(g, n):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    a = torch.from_numpy(_mats(g, n, "lowrank", seed=6)).cuda()
    before = K.ns_sqrtm_yz.launches
    y, z = K.ns_sqrtm_yz(a, 12)
    py, pz = K.ns_sqrtm_yz_plain(a, 12)
    torch.cuda.synchronize()
    assert K.ns_sqrtm_yz.launches == before + 1
    # The same tolerances as chip_smoke.py: tr(Y) to rtol 1e-4, Z to 1e-3
    # of max|Z|.
    torch.testing.assert_close(TS._batch_trace(y), TS._batch_trace(py),
                               rtol=1e-4, atol=0)
    assert ((z - pz).abs().max() / pz.abs().max()).item() < 1e-3


def _card_mats(shapes, seed):
    return [torch.from_numpy(_mats(g, n, "lowrank", seed=seed + k)).cuda()
            for k, (g, n) in enumerate(shapes)]


@pytest.mark.cuda
@pytest.mark.parametrize("shapes", [
    [(1, 64), (1, 128), (1, 256), (2, 512)],
    [(1, 100), (1, 300)],
    [(3, 200), (1, 512)],
])
def test_grouped_launch_against_per_group_kernels_on_card(shapes):
    """One grouped launch for every group: a group of the GEMM regime
    (C > 256), whose 64x64 tiles the launch keeps, equals the per-group
    kernels bit for bit; every group meets the plain chain at the per-group
    test's tolerances. One B1 launch is counted, and one ``ns-groups``
    counter records the groups and each one's blocks."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    mats = _card_mats(shapes, 20)
    before, first = K.ns_sqrtm_yz.launches, len(TR.events())
    out = K.ns_sqrtm_yz_groups(mats, 12)
    torch.cuda.synchronize()
    assert K.ns_sqrtm_yz.launches == before + 1
    (rec,) = [e for e in TR.events()[first:] if e.name == "ns-groups"]
    assert rec.value["groups"] == len(shapes)
    assert sorted(tuple(b[:2]) for b in rec.value["blocks"]) == sorted(shapes)
    for (y, z), a in zip(out, mats):
        if a.shape[-1] > 256:
            sy, sz = K.ns_sqrtm_yz_serial(a, 12)
            assert torch.equal(y, sy) and torch.equal(z, sz)
        py, pz = K.ns_sqrtm_yz_plain(a, 12)
        torch.testing.assert_close(TS._batch_trace(y), TS._batch_trace(py), rtol=1e-4, atol=0)
        assert ((z - pz).abs().max() / pz.abs().max()).item() < 1e-3


@pytest.mark.cuda
def test_grouped_launch_graph_replay_on_card():
    """The grouped launch captured in a CUDA graph and replayed equals its
    eager launch bit for bit (its barrier words are zeroed inside the
    graph, so every replay starts afresh)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (runs on the card)")
    torch.backends.cuda.matmul.allow_tf32 = False
    mats = _card_mats([(1, 64), (1, 128), (1, 256), (2, 512)], 30)
    eager = [t.clone() for yz in K.ns_sqrtm_yz_groups(mats, 12) for t in yz]
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream):
        out = [t for yz in K.ns_sqrtm_yz_groups(mats, 12) for t in yz]
    for _ in range(2):
        for t in out:
            t.fill_(float("nan"))
        graph.replay()
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(eager, out))
