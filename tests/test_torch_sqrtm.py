"""PyTorch port: Newton-Schulz square roots and the CUDA kernel's wrapper.

The port's plain ``trace_sqrtm_ns`` is held, value and gradient, against the
JAX package's XLA version and against its Pallas kernel run in interpret
mode. The CUDA kernel itself runs only on the card (``-m cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from style_transfer_tpu.ops import sqrtm as JS
from style_transfer_tpu.ops.pallas.ns_sqrtm import trace_sqrtm_ns_pallas
from style_transfer_tpu_torch.ops import sqrtm as TS
from style_transfer_tpu_torch.ops.cuda import build
from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

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
