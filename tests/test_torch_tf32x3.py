"""PyTorch port: the 3xTF32 arithmetic of the Newton-Schulz CUDA kernels.

The kernels multiply every pair of FP32 operands as three TF32 tensor-core
products (``csrc/ns_sqrtm.cu``). That arithmetic runs here through its plain
emulation in ``ops/cuda/ns_sqrtm.py`` (TF32 head/tail split by bit rounding,
three products, FP32 sums): the NS chain (Y, Z) and the Lyapunov solve run
with it agree with the FP32 plain versions and with the JAX package's XLA
``ops/sqrtm.py`` within the kernel limits that ``chip_smoke.py`` holds the
card to. The shortened first NS iteration (no products by Z_0 = I) equals
the plain chain's first iteration bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from style_transfer_tpu.ops import sqrtm as JS
from style_transfer_tpu_torch.ops import sqrtm as TS
from style_transfer_tpu_torch.ops.cuda import ns_sqrtm as K

torch.set_num_threads(2)

ITERS = 12
# chip_smoke.py's kernel limits: tr(Y) relative, Y of max|Y|, Z and Q of max.
RTOL_TRACE, TOL_Y, TOL_Z, TOL_Q = 1e-4, 1e-4, 1e-3, 1e-3


def _mats(g, n, kind, seed=0):
    """SPD (full rank + 1e-3 I) or rank-deficient (rank n/4) + 1e-4 I."""
    rng = np.random.RandomState(seed)
    r = n if kind == "spd" else n // 4
    eps = 1e-3 if kind == "spd" else 1e-4
    x = rng.randn(g, n, r).astype(np.float32)
    return (x @ x.transpose(0, 2, 1) / n + eps * np.eye(n, dtype=np.float32)
            ).astype(np.float32)


def _rel(x, ref):
    x, ref = np.asarray(x, np.float64), np.asarray(ref, np.float64)
    return float(np.abs(x - ref).max() / np.abs(ref).max())


def _trace_rel(y, ref):
    t, tr = np.trace(y, axis1=-2, axis2=-1), np.trace(ref, axis1=-2, axis2=-1)
    return float(np.max(np.abs(t - tr) / np.abs(tr)))


CHAIN_CASES = [(1, n, kind) for n in (64, 100, 128) for kind in ("spd", "lowrank")]


def test_tf32_round_is_round_to_nearest_ties_away():
    one_ulp = 2.0 ** -10  # TF32 keeps 10 mantissa bits
    x = torch.tensor([1 + 2 ** -11, 1 + 2 ** -12, -(1 + 2 ** -11), 3 * 2 ** -11 + 1,
                      1 + one_ulp + 2 ** -11], dtype=torch.float32)
    want = torch.tensor([1 + one_ulp, 1.0, -(1 + one_ulp), 1 + 2 * one_ulp,
                         1 + 2 * one_ulp], dtype=torch.float32)
    assert torch.equal(K.tf32_round(x), want)
    r = torch.from_numpy(np.random.RandomState(0).randn(1000).astype(np.float32))
    h = K.tf32_round(r)
    assert not (h.view(torch.int32) & 0x1FFF).any()  # the 13 dropped bits are 0
    assert ((r - h).abs() <= r.abs() * 2.0 ** -11).all()


@pytest.mark.parametrize("n", [8, 100, 256])
def test_matmul_tf32x3_is_fp32_accurate(n):
    rng = np.random.RandomState(n)
    a = rng.randn(n, n).astype(np.float32)
    b = rng.randn(n, n).astype(np.float32)
    ref = a.astype(np.float64) @ b.astype(np.float64)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    err3 = _rel(K.matmul_tf32x3(ta, tb).numpy(), ref)
    err32 = _rel((ta @ tb).numpy(), ref)
    err1 = _rel((K.tf32_round(ta) @ K.tf32_round(tb)).numpy(), ref)
    # 3xTF32 keeps about 22 mantissa bits of each operand: within a few
    # FP32 matmul errors, and far from one TF32 pass.
    assert err3 < max(4 * err32, 1e-6)
    assert err1 > 50 * err3


@pytest.mark.parametrize("g,n,kind", CHAIN_CASES)
def test_ns_chain_tf32x3_matches_plain_and_jax(g, n, kind):
    a = _mats(g, n, kind, seed=n)
    y, z = (t.numpy() for t in K.ns_sqrtm_yz_tf32x3(torch.from_numpy(a), ITERS))
    py, pz = (t.numpy() for t in K.ns_sqrtm_yz_plain(torch.from_numpy(a), ITERS))
    jy, jz = (np.asarray(t) for t in JS._sqrtm_ns_yz(jnp.asarray(a), ITERS))
    for ref_y, ref_z in ((py, pz), (jy, jz)):
        assert _trace_rel(y, ref_y) < RTOL_TRACE
        assert _rel(y, ref_y) < TOL_Y
        assert _rel(z, ref_z) < TOL_Z


@pytest.mark.parametrize("g,n,kind", CHAIN_CASES)
def test_lyap_tf32x3_matches_plain_and_jax(g, n, kind):
    a = torch.from_numpy(_mats(g, n, kind, seed=n + 1))
    z = TS.sqrtm_ns(a, ITERS)
    gr = torch.from_numpy(np.random.RandomState(n).randn(g, n, n).astype(np.float32))
    q = K.lyap_bwd_tf32x3(z, gr, ITERS).numpy()
    pq = K.lyap_bwd_plain(z, gr, ITERS).numpy()
    jq = np.asarray(JS._lyap_backward(jnp.asarray(z.numpy()), jnp.asarray(gr.numpy()), ITERS))
    assert _rel(q, pq) < TOL_Q
    assert _rel(q, jq) < TOL_Q


@pytest.mark.parametrize("n,kind,seed", [(64, "spd", 0), (100, "lowrank", 1), (128, "spd", 2)])
def test_short_first_iteration_equals_plain_bit_for_bit(n, kind, seed):
    a = torch.from_numpy(_mats(1, n, kind, seed=seed))
    y0 = a / torch.sqrt(torch.sum(a * a, dim=(-2, -1), keepdim=True))
    eye = torch.eye(n)
    z0 = eye.expand_as(a)
    t_plain = (3.0 * eye - z0 @ y0) * 0.5  # the plain chain's first iteration
    z1_plain = t_plain @ z0
    t0, z1 = K.ns_first_iteration(y0)
    assert torch.equal(t0, t_plain)
    assert torch.equal(z1, z1_plain)
    assert torch.equal(y0 @ t0, y0 @ t_plain)
