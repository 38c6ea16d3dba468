"""PyTorch port: checkpoint/resume on the CPU, against itself and across
packages.

The file format is the JAX package's (v3, NHWC arrays), so a checkpoint
written by either package resumes in the other. The port's resumed run
equals its uninterrupted run bit for bit; across packages the continuation
agrees to the pyramid parity bound (rtol 2e-3 in loss, > 40 dB PSNR).
"""

import shutil

import numpy as np
import pytest
import torch

import style_transfer_tpu as J
import style_transfer_tpu_torch as T
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu.utils import checkpoint as jck
from style_transfer_tpu_torch.step import AdamState, LBFGSState
from style_transfer_tpu_torch.utils import checkpoint as tck
from style_transfer_tpu_torch.utils.ema import EMAState

torch.set_num_threads(2)

PARAMS = random_params(0)
# A 64 px canvas (64x48 from the conftest's 128x96 content), 20 iterations,
# a checkpoint every chunk of 10.
RUN = dict(min_scale=64, end_scale=64, iterations=20, initial_iterations=20,
           checkpoint_every=10)
LOSS_RTOL = 2e-3  # the pyramid parity bound (test_torch_engine.py)


class Stop(Exception):
    pass


def _stop_at(i):
    def callback(it):
        if it.i >= i:
            raise Stop
    return callback


def _psnr(a, b):
    return 10 * np.log10(1.0 / max(float(np.mean((a - b) ** 2)), 1e-12))


def _port(**kw):
    return T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=10, **kw)


def _port_run(content, style, **kw):
    st, its = _port(), []
    st.stylize(content, [style], callback=its.append, **RUN, **kw)
    return st, its


def _port_interrupted(content, style, path, at=10, **kw):
    st = _port()
    with pytest.raises(Stop):
        st.stylize(content, [style], checkpoint=str(path), callback=_stop_at(at),
                   **RUN, **kw)
    assert path.is_file()


@pytest.fixture(scope="module")
def jax_engine():
    st = J.StyleTransfer(devices=1, weights=PARAMS, compute_dtype="float32",
                         sqrtm_impl="xla", w2_grad="trace", callback_chunk=10)
    # The JAX engine fuses a small scale into one chunk (``_chunk_for``); pin
    # its chunk to the callback's so that a checkpoint lands mid-scale.
    st._chunk_for = lambda ch, cw, its: min(10, its)
    return st


@pytest.fixture(scope="module")
def jax_resumed(jax_engine, tmp_path_factory):
    """The JAX engine interrupted at iteration 10 (its checkpoint copied),
    then resumed to the end in the same engine: the reference continuation,
    since the JAX package's resume equals its uninterrupted run."""
    d = tmp_path_factory.mktemp("jax_ck")
    content, style = _images()
    path = d / "ck.npz"
    with pytest.raises(Stop):
        jax_engine.stylize(content, [style], checkpoint=str(path),
                           callback=_stop_at(10), **RUN)
    shutil.copy(path, d / "ck10.npz")
    its = []
    jax_engine.stylize(content, [style], checkpoint=str(path), resume=True,
                       callback=its.append, **RUN)
    return d / "ck10.npz", its, jax_engine.get_image_tensor()


def _images():
    """The conftest's content and style images (module fixtures cannot take
    its function-scoped ones)."""
    from PIL import Image

    h, w = 96, 128
    yy, xx = np.mgrid[0:h, 0:w]
    arr = np.stack([xx / w * 255, yy / h * 255, (xx + yy) / (h + w) * 255], -1)
    style = np.random.RandomState(7).randint(0, 255, (80, 80, 3)).astype(np.uint8)
    return Image.fromarray(arr.astype(np.uint8)), Image.fromarray(style)


def _nhwc_state(rng, hw=(8, 8)):
    def a(*shape):
        return torch.from_numpy(rng.rand(*shape).astype(np.float32))

    h, w = hw
    return a(1, h, w, 3), EMAState(value=a(1, h, w, 3), accum=torch.tensor(0.9))


def test_roundtrip_of_port_state(tmp_path):
    """Torch tensors in (Adam and L-BFGS), the same values out as arrays."""
    rng = np.random.RandomState(0)
    img, ema = _nhwc_state(rng)
    adam = AdamState(mu=img * 2, nu=img * 3, count=42)
    p = tmp_path / "ck.npz"
    tck.save_checkpoint(p, image=img, adam=adam, ema=ema, scale_index=2,
                        done_iters=150, meta={"w": 8, "h": 8})
    ck = tck.load_checkpoint(p)
    np.testing.assert_array_equal(ck["image"], img.numpy())
    np.testing.assert_array_equal(ck["adam_nu"], adam.nu.numpy())
    np.testing.assert_array_equal(ck["ema_value"], ema.value.numpy())
    assert ck["adam_count"].dtype == np.int32 and int(ck["adam_count"]) == 42
    assert ck["scale_index"] == 2 and ck["done_iters"] == 150
    assert ck["meta"] == {"w": 8, "h": 8} and ck["version"] == 3

    lb = LBFGSState(*(torch.from_numpy(np.asarray(rng.rand(*s), dt)) for s, dt in (
        ((10, 1, 8, 8, 3), np.float32), ((10, 1, 8, 8, 3), np.float32),
        ((10,), np.float32), ((), np.int32), ((), np.int32),
        ((1, 8, 8, 3), np.float32), ((), np.float32), ((1, 8, 8, 3), np.float32),
        ((), np.float32), ((), np.int32))))
    tck.save_checkpoint(p, image=img, lbfgs=lb, ema=ema, scale_index=0,
                        done_iters=3, optimizer="lbfgs")
    ck = tck.load_checkpoint(p)
    assert ck["lbfgs_fields"] == list(LBFGSState._fields)
    for name in LBFGSState._fields:
        got = ck[f"lbfgs_{name}"]
        assert got.dtype == getattr(lb, name).numpy().dtype
        np.testing.assert_array_equal(got, getattr(lb, name).numpy())
    with pytest.raises(ValueError, match="exactly one"):
        tck.save_checkpoint(p, image=img, ema=ema, scale_index=0, done_iters=0)


def test_port_layout_equals_jax_layout(tmp_path, jax_resumed, content_pil,
                                       style_pil):
    """The port's file and the JAX package's, both written at iteration 10
    of the same run, have the same keys, shapes (NHWC), dtypes and header
    fields, and JAX's ``load_checkpoint`` reads the port's."""
    _port_interrupted(content_pil, style_pil, tmp_path / "ck.npz")
    mine = jck.load_checkpoint(tmp_path / "ck.npz")
    ref = jck.load_checkpoint(jax_resumed[0])
    assert set(mine) == set(ref)
    for k, v in ref.items():
        if isinstance(v, np.ndarray):
            assert (mine[k].shape, mine[k].dtype) == (v.shape, v.dtype), k
        else:
            assert mine[k] == v, k
    assert mine["image"].shape == (1, 48, 64, 3)
    # Same state to the pyramid bound: the content init and 10 Adam steps.
    assert int(mine["adam_count"]) == int(ref["adam_count"]) == 10
    assert _psnr(mine["ema_value"] / (1 - mine["ema_accum"]),
                 ref["ema_value"] / (1 - ref["ema_accum"])) > 40.0


def test_jax_checkpoint_resumes_in_port(tmp_path, jax_resumed, content_pil,
                                        style_pil):
    ck10, j_its, j_img = jax_resumed
    path = tmp_path / "ck.npz"
    shutil.copy(ck10, path)
    st, its = _port(), []
    st.stylize(content_pil, [style_pil], checkpoint=str(path), resume=True,
               callback=its.append, **RUN)
    assert [i.i for i in its] == [i.i for i in j_its] == list(range(11, 21))
    np.testing.assert_allclose([i.loss for i in its], [i.loss for i in j_its],
                               rtol=LOSS_RTOL)
    assert _psnr(st.get_image_tensor(), j_img) > 40.0


def test_port_checkpoint_resumes_in_jax(tmp_path, jax_engine, content_pil,
                                        style_pil):
    """The port writes at iteration 10; the JAX engine resumes from it and
    follows the port's own uninterrupted run."""
    st, t_its = _port_run(content_pil, style_pil)
    path = tmp_path / "ck.npz"
    _port_interrupted(content_pil, style_pil, path)
    j_its = []
    jax_engine.stylize(content_pil, [style_pil], checkpoint=str(path),
                       resume=True, callback=j_its.append, **RUN)
    assert [i.i for i in j_its] == list(range(11, 21))
    np.testing.assert_allclose([i.loss for i in j_its],
                               [i.loss for i in t_its[10:]], rtol=LOSS_RTOL)
    assert _psnr(jax_engine.get_image_tensor(), st.get_image_tensor()) > 40.0


@pytest.mark.parametrize("optimizer,init", [("adam", "content"), ("lbfgs", "gray")])
def test_port_resume_is_exact(tmp_path, content_pil, style_pil, optimizer, init):
    """Interrupted at 10, resumed to 20: the same losses and image, bit for
    bit (L-BFGS from the gray init, see ROADMAP C)."""
    kw = dict(optimizer=optimizer, init=init)
    st_a, a_its = _port_run(content_pil, style_pil, **kw)
    path = tmp_path / "ck.npz"
    _port_interrupted(content_pil, style_pil, path, **kw)
    assert tck.load_checkpoint(path)["optimizer"] == optimizer
    st_c, c_its = _port(), []
    st_c.stylize(content_pil, [style_pil], checkpoint=str(path), resume=True,
                 callback=c_its.append, **RUN, **kw)
    assert [i.i for i in c_its] == list(range(11, 21))
    assert [i.loss for i in c_its] == [i.loss for i in a_its[10:]]
    np.testing.assert_array_equal(st_c.get_image_tensor(), st_a.get_image_tensor())


def test_cadence(tmp_path, content_pil, style_pil, monkeypatch):
    """``checkpoint_every`` gates the mid-scale writes; scale ends always
    write."""
    calls = []
    real = tck.save_checkpoint

    def counting(path, **kw):
        calls.append((kw["scale_index"], kw["done_iters"]))
        real(path, **kw)

    monkeypatch.setattr(tck, "save_checkpoint", counting)
    st = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=5)
    st.stylize(content_pil, [style_pil], min_scale=48, end_scale=68,
               iterations=10, initial_iterations=15,
               checkpoint=str(tmp_path / "ck.npz"), checkpoint_every=10)
    # Chunks of 5: scale 0 writes at 10 (cadence) and 15 (its end); scale 1
    # at 10, its end, which also meets the cadence.
    assert calls == [(0, 10), (0, 15), (1, 10)]
    calls.clear()
    st.stylize(content_pil, [style_pil], min_scale=48, end_scale=68,
               iterations=10, initial_iterations=15,
               checkpoint=str(tmp_path / "ck.npz"), checkpoint_every=1000)
    assert calls == [(0, 15), (1, 10)]


def test_async_writer_latest_wins(tmp_path):
    rng = np.random.RandomState(1)
    img, ema = _nhwc_state(rng, (4, 4))
    adam = AdamState(mu=img, nu=img, count=1)
    p = tmp_path / "ck.npz"
    w = tck.AsyncCheckpointWriter()
    try:
        for it in range(1, 8):
            w.submit(str(p), image=torch.full((1, 4, 4, 3), float(it)),
                     adam=adam, ema=ema, scale_index=0, done_iters=it * 10)
        w.flush()
        ck = tck.load_checkpoint(p)
        assert ck["done_iters"] % 10 == 0 and ck["done_iters"] <= 70
        w.submit(str(p), image=torch.full((1, 4, 4, 3), 99.0),
                 adam=adam, ema=ema, scale_index=1, done_iters=99)
        w.flush()
        ck = tck.load_checkpoint(p)
        assert ck["done_iters"] == 99 and ck["scale_index"] == 1
        np.testing.assert_array_equal(ck["image"], 99.0)
    finally:
        w.close()


def test_async_writer_surfaces_errors(tmp_path):
    rng = np.random.RandomState(2)
    img, ema = _nhwc_state(rng, (4, 4))
    w = tck.AsyncCheckpointWriter()
    w.submit(str(tmp_path / "nodir" / "\0bad"), image=img,
             adam=AdamState(mu=img, nu=img, count=1), ema=ema,
             scale_index=0, done_iters=1)
    with pytest.raises(Exception):
        w.close()


def test_rng_state_roundtrip(tmp_path):
    rng = np.random.RandomState(0)
    rng.rand(100)
    expected = np.random.RandomState(0)
    expected.rand(100)
    img, ema = _nhwc_state(np.random.RandomState(3), (4, 4))
    p = tmp_path / "ck.npz"
    tck.save_checkpoint(p, image=img, adam=AdamState(mu=img, nu=img, count=1),
                        ema=ema, scale_index=0, done_iters=1, rng=rng)
    ck = tck.load_checkpoint(p)
    fresh = np.random.RandomState(99)
    tck.unpack_rng_state(fresh, ck["rng"], ck["rng_keys"])
    np.testing.assert_array_equal(fresh.rand(5), expected.rand(5))
    # The JAX package reads the same fields.
    fresh = np.random.RandomState(99)
    jck.unpack_rng_state(fresh, jck.load_checkpoint(p)["rng"], ck["rng_keys"])
    np.testing.assert_array_equal(fresh.rand(5), np.random.RandomState(0).rand(105)[100:])


@pytest.mark.parametrize("case", ["optimizer", "scale_index", "geometry", "transposed"])
def test_resume_refusals(tmp_path, content_pil, style_pil, case):
    """Each refusal, with the JAX package's message where it has one,
    before any work."""
    img, ema = _nhwc_state(np.random.RandomState(4), (48, 64))
    header = dict(scale_index=0, done_iters=5, meta={"w": 64, "h": 48})
    if case == "scale_index":
        header["scale_index"] = 3
    if case == "geometry":
        header["meta"] = {"w": 96, "h": 72}
    if case == "transposed":  # a JAX checkpoint of a transposed TPU run
        header["meta"] = {"w": 64, "h": 48, "transposed": True}
    p = tmp_path / "ck.npz"
    tck.save_checkpoint(p, image=img, adam=AdamState(mu=img, nu=img, count=5),
                        ema=ema, **header)
    match = {"optimizer": "written with optimizer 'adam'; refusing",
             "scale_index": "out of range", "geometry": "does not match",
             "transposed": "transposed=True"}[case]
    with pytest.raises(ValueError, match=match):
        _port().stylize(content_pil, [style_pil], checkpoint=str(p), resume=True,
                        optimizer="lbfgs" if case == "optimizer" else "adam",
                        **RUN)


def test_resume_skips_completed_scales(tmp_path, content_pil, style_pil):
    ck = tmp_path / "ck.npz"
    kw = dict(min_scale=48, end_scale=68, iterations=5, initial_iterations=5)
    st = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=5)
    st.stylize(content_pil, [style_pil], checkpoint=str(ck), **kw)
    assert tck.load_checkpoint(ck)["scale_index"] == 1  # ended on the last scale
    its = []
    st2 = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=5)
    out = st2.stylize(content_pil, [style_pil], checkpoint=str(ck), resume=True,
                      callback=its.append, **kw)
    assert its == []  # everything was done
    np.testing.assert_array_equal(np.asarray(out), np.asarray(st.get_image()))


def test_interrupt_in_callback_leaves_resumable_file(tmp_path, content_pil,
                                                     style_pil):
    """A KeyboardInterrupt raised by the first callback after a snapshot was
    submitted: the file holds that snapshot, and a resume continues it."""
    ck = tmp_path / "ck.npz"
    kw = dict(min_scale=48, end_scale=48, iterations=10, initial_iterations=10)
    st = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=5)

    def interrupt(it):
        if it.i == 6:
            raise KeyboardInterrupt

    with pytest.raises(KeyboardInterrupt):
        st.stylize(content_pil, [style_pil], checkpoint=str(ck), checkpoint_every=5,
                   callback=interrupt, **kw)
    assert tck.load_checkpoint(ck)["done_iters"] == 10  # the last chunk's
    # ... so the run was already whole; resume with a longer scale instead.
    kw["initial_iterations"] = kw["iterations"] = 15
    its = []
    T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=5).stylize(
        content_pil, [style_pil], checkpoint=str(ck), resume=True,
        callback=its.append, **kw)
    assert [i.i for i in its] == [11, 12, 13, 14, 15]


def test_snapshot_holds_its_iteration(tmp_path, content_pil, style_pil,
                                      monkeypatch):
    """The snapshot handed to the writer holds the chunk's own tensors, no
    copies: after the run has gone on, they still hold the values of the
    iteration they were taken at (no step writes a tensor in place)."""
    taken = []
    real = tck.AsyncCheckpointWriter.submit

    def submit(self, path, **state):
        flat = {"image": state["image"], "ema": state["ema"].value,
                **{f"lbfgs_{k}": v for k, v in state["lbfgs"]._asdict().items()}}
        taken.append({k: (v, v.clone()) for k, v in flat.items()})
        real(self, path, **state)

    monkeypatch.setattr(tck.AsyncCheckpointWriter, "submit", submit)
    st = T.StyleTransfer(device="cpu", weights=PARAMS, callback_chunk=5)
    st.stylize(content_pil, [style_pil], min_scale=48, end_scale=48,
               iterations=15, initial_iterations=15, optimizer="lbfgs",
               init="gray", checkpoint=str(tmp_path / "ck.npz"), checkpoint_every=5)
    assert len(taken) == 3
    for snap in taken:
        for k, (held, at_submit) in snap.items():
            assert torch.equal(held, at_submit), k
    # And they differ from one snapshot to the next (the run went on).
    assert not torch.equal(taken[0]["image"][0], taken[-1]["image"][0])
