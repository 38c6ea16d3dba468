"""PyTorch port: CLI options beyond the Adam default, on the CPU."""

import json

import numpy as np
import pytest
import torch

from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch import cli as tcli

torch.set_num_threads(2)


@pytest.fixture()
def files(tmp_path, content_pil, style_pil):
    content, style = tmp_path / "c.png", tmp_path / "s.png"
    content_pil.save(content)  # 128x96
    style_pil.save(style)
    weights = tmp_path / "w.npz"
    np.savez(weights, **random_params(0))
    return [str(content), str(style), "--devices", "cpu", "--vgg-weights",
            str(weights), "-o", str(tmp_path / "out.png"),
            "--trace", str(tmp_path / "trace.json")], tmp_path / "trace.json"


def test_optimizer_lbfgs_runs(files):
    argv, trace = files
    tcli.main(argv + ["--optimizer", "lbfgs", "--end-scale", "48", "-ii", "4"])
    t = json.loads(trace.read_text())
    assert t["args"]["optimizer"] == "lbfgs"
    assert [it["i"] for it in t["iterates"]] == [1, 2, 3, 4]
    assert all(np.isfinite(it["loss"]) for it in t["iterates"])


def test_optimizer_lbfgs_zoom_runs(files, capsys):
    """``--optimizer lbfgs-zoom`` runs; with ``--checkpoint`` it warns, as
    the JAX engine, and writes no file."""
    argv, trace = files
    ck = trace.parent / "ck.npz"
    tcli.main(argv + ["--optimizer", "lbfgs-zoom", "--end-scale", "48", "-ii", "4",
                      "--checkpoint", str(ck), "--checkpoint-every", "2"])
    t = json.loads(trace.read_text())
    assert t["args"]["optimizer"] == "lbfgs-zoom"
    assert [it["i"] for it in t["iterates"]] == [1, 2, 3, 4]
    losses = [it["loss"] for it in t["iterates"]]
    assert all(np.isfinite(losses)) and losses[-1] < losses[0]
    assert "no checkpoints will be written for this lbfgs-zoom run" in capsys.readouterr().out
    assert not ck.exists()


def test_end_scale_plus(files):
    """``--end-scale N+`` caps the total pixels of a non-square canvas."""
    argv, trace = files
    tcli.main(argv + ["--end-scale", "64+", "--min-scale", "64", "-i", "2",
                      "-ii", "2", "--callback-chunk", "2"])
    t = json.loads(trace.read_text())
    # 128x96 content, 4:3 aspect: safe scale = sqrt(4/3)*64 = 73
    assert t["args"]["end_scale"] == int((128 / 96) ** 0.5 * 64)
    assert {(it["w"], it["h"]) for it in t["iterates"]} == {(73, 55)}


def test_new_flags_take_stylize_defaults():
    from style_transfer_tpu_torch import StyleTransfer

    defaults = StyleTransfer.stylize.__kwdefaults__
    args = tcli.build_parser(StyleTransfer.stylize).parse_args(["c", "s"])
    assert (args.checkpoint, args.checkpoint_every, args.resume) == (
        defaults["checkpoint"], defaults["checkpoint_every"], defaults["resume"])
    assert (args.checkpoint, args.checkpoint_every, args.resume) == (None, 500, False)
    assert (args.web, args.host, args.port, args.browser) == (False, "0.0.0.0", 8080, "")
    assert args.precision == "auto"
    args = tcli.build_parser(StyleTransfer.stylize).parse_args(
        ["c", "s", "--checkpoint", "ck.npz", "--checkpoint-every", "7", "--resume",
         "--web", "--host", "127.0.0.1", "--port", "1234", "--browser",
         "--precision", "bf16"])
    assert (args.checkpoint, args.checkpoint_every, args.resume) == ("ck.npz", 7, True)
    assert (args.web, args.host, args.port, args.browser) == (True, "127.0.0.1", 1234, None)
    assert args.precision == "bf16"


def test_checkpoint_resume_end_to_end(files, monkeypatch):
    """Through the CLI: an uninterrupted run, a run interrupted by Ctrl-C at
    iteration 5 (after the snapshot of iteration 6 was submitted), and its
    --resume, whose iterations 7-8 and output equal the uninterrupted run's."""
    from PIL import Image

    argv, trace = files
    out = trace.parent / "out.png"
    ck = trace.parent / "ck.npz"
    run = argv + ["--end-scale", "48", "-ii", "8", "--callback-chunk", "2",
                  "--checkpoint-every", "2"]
    tcli.main(run)
    full = json.loads(trace.read_text())["iterates"]
    with Image.open(out) as img:
        full_img = np.asarray(img)

    real = tcli.Callback.__call__

    def interrupting(self, iterate):
        if iterate.i == 5:
            raise KeyboardInterrupt
        real(self, iterate)

    monkeypatch.setattr(tcli.Callback, "__call__", interrupting)
    tcli.main(run + ["--checkpoint", str(ck)])
    assert [it["i"] for it in json.loads(trace.read_text())["iterates"]] == [1, 2, 3, 4]
    monkeypatch.setattr(tcli.Callback, "__call__", real)
    tcli.main(run + ["--checkpoint", str(ck), "--resume"])
    resumed = json.loads(trace.read_text())["iterates"]
    assert [it["i"] for it in resumed] == [7, 8]
    assert [it["loss"] for it in resumed] == [it["loss"] for it in full[6:]]
    with Image.open(out) as img:
        np.testing.assert_array_equal(np.asarray(img), full_img)


def test_web_end_to_end(files, monkeypatch):
    """``--web`` through the CLI: a client that connected as the server
    started gets the page, each iterate, the canvas-size JPEG and WIDone,
    and the child is gone when main returns."""
    import io
    import socket
    import threading

    from PIL import Image

    from style_transfer_tpu_torch.web import client, server

    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    seen = {"events": [], "pages": []}
    made = []

    class Watched(server.WebInterface):
        def __init__(self, host, port_):
            super().__init__(host, port_)
            made.append(self)
            seen["pages"].append(client.get(host, port_, "/")[0])
            stream = client.EventStream(host, port_, timeout=60)

            def read():
                with stream:
                    for event in stream:
                        seen["events"].append(event)
                        if len(seen["events"]) == 1:
                            status, body, _ = client.get(host, port_, "/image")
                            with Image.open(io.BytesIO(body)) as jpeg:
                                seen["image"] = (status, jpeg.size,
                                                 "icc_profile" in jpeg.info)

            self.reader = threading.Thread(target=read, daemon=True)
            self.reader.start()

    monkeypatch.setattr(server, "WebInterface", Watched)
    argv, trace = files
    tcli.main(argv + ["--end-scale", "48", "-ii", "4", "--callback-chunk", "2",
                      "--web", "--host", "127.0.0.1", "--port", str(port)])
    (wi,) = made
    wi.reader.join(30)
    assert not wi.reader.is_alive() and not wi.process.is_alive()
    assert seen["pages"] == [200]
    kinds = [e["_type"] for e in seen["events"]]
    assert kinds == ["STIterate"] * 4 + ["WIDone"]
    assert {(e["w"], e["h"]) for e in seen["events"][:4]} == {(48, 36)}
    assert seen["image"] == (200, (48, 36), True)


def test_web_without_server_raises(files, monkeypatch):
    """--web when the server cannot start: main raises before any work."""
    import importlib.util

    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "aiohttp" else real(name, *a))
    argv, trace = files
    with pytest.raises(RuntimeError, match="aiohttp"):
        tcli.main(argv + ["--end-scale", "48", "-ii", "2", "--web"])
    assert not trace.exists()


class _StubEngine:
    def get_image_device(self):
        return torch.zeros((1, 4, 4, 3))

    def get_image_tensor(self):
        return np.zeros((4, 4, 3), np.float32)


class _StubWeb:
    def __init__(self):
        self.iterates, self.done = [], 0

    def put_iterate(self, iterate, image):
        self.iterates.append(iterate)

    def put_done(self):
        self.done += 1


def _iterate(w, h, i, i_max):
    from style_transfer_tpu_torch.utils.trace import STIterate

    return STIterate(w=w, h=h, i=i, i_max=i_max, loss=1.0, time=0.0, gpu_ram=0)


def _args(**kw):
    import argparse

    kw.setdefault("output", "out.png")
    kw.setdefault("save_every", 1000)
    kw.setdefault("end_scale", 500)
    return argparse.Namespace(**kw)


@pytest.mark.parametrize("final_dims", [(496, 368), None])
def test_callback_final_scale(monkeypatch, final_dims):
    """The last scale is found from the aligned final canvas (--align 16
    --end-scale 500 gives 496x368, whose max dim is not 500), or without
    ``final_dims`` from end_scale: an earlier scale's end saves (async), the
    last one puts WIDone instead."""
    saves = []
    monkeypatch.setattr(tcli, "save_image", lambda path, img: saves.append(img.size))
    web = _StubWeb()
    end = (496, 368) if final_dims else (500, 375)
    cb = tcli.Callback(_StubEngine(), _args(final_dims=final_dims), web_interface=web)
    cb(_iterate(256, 192, 10, 10))
    cb.saver.flush()
    assert saves == [(4, 4)] and web.done == 0
    cb(_iterate(*end, 10, 10))
    cb.close()
    assert saves == [(4, 4)] and web.done == 1 and len(web.iterates) == 2
    assert len(cb.get_trace()["iterates"]) == 2


def test_callback_progress_lazy_on_resume(monkeypatch):
    monkeypatch.setattr(tcli, "save_image", lambda *a: None)
    cb = tcli.Callback(_StubEngine(), _args(end_scale=64, final_dims=(64, 48)))
    cb(_iterate(64, 48, 11, 20))  # a resumed run's first callback
    assert cb.progress is not None and cb.progress.n == 11
    cb(_iterate(64, 48, 12, 20))
    assert cb.progress.n == 12
    cb(_iterate(64, 48, 20, 20))
    assert cb.progress is None
    cb.close()


def test_saver_flushed_before_final_save(files, monkeypatch):
    """A slow async save of the last mid-run image must land before main's
    synchronous final save, never after it."""
    import threading
    import time

    real = tcli.save_image
    log = []

    def slow(path, image):
        if threading.current_thread().name == "stt-save":
            time.sleep(0.3)
        log.append(threading.current_thread().name)
        real(path, image)

    monkeypatch.setattr(tcli, "save_image", slow)
    argv, _ = files
    tcli.main(argv + ["--end-scale", "48", "-ii", "4", "--callback-chunk", "2",
                      "--save-every", "3"])
    assert log == ["stt-save", "MainThread"]


def test_get_image_tensor_fetches_once_per_chunk(content_pil, style_pil, monkeypatch):
    """Callbacks read the image per iteration; the device is read once per
    chunk (the cache is keyed on the EMA state object)."""
    from style_transfer_tpu_torch import StyleTransfer
    from style_transfer_tpu_torch import engine as E

    fetches, in_callback = [], [False]
    real = E.ema_get

    def counting(state):
        if in_callback[0]:
            fetches.append(state)
        return real(state)

    monkeypatch.setattr(E, "ema_get", counting)
    st = StyleTransfer(device="cpu", weights=random_params(0), callback_chunk=3)
    images = []

    def callback(it):
        in_callback[0] = True
        images.append(st.get_image_tensor())
        st.get_image_tensor()
        in_callback[0] = False

    st.stylize(content_pil, [style_pil], min_scale=48, end_scale=48, iterations=9,
               initial_iterations=9, callback=callback)
    assert len(images) == 9 and len(fetches) == 3  # 3 chunks of 3
    assert images[0] is images[2] and images[2] is not images[3]
    dev = st.get_image_device()
    assert dev.shape == (1, 36, 48, 3)
    np.testing.assert_array_equal(dev[0].numpy(), st.get_image_tensor())


def test_proof_soft_proofs_the_inputs(files, monkeypatch):
    """``--proof`` runs the src -> CMYK -> sRGB load path (ref cli.py:41-43)
    with the committed hand-built CMYK profile: the inputs reach the engine
    changed by the round trip, and the output is written with the sRGB
    profile. Runs chdir'd into tmp_path, as the JAX test does."""
    from pathlib import Path

    from PIL import Image

    from style_transfer_tpu_torch import io_color

    argv, trace = files
    monkeypatch.chdir(trace.parent)
    proof = Path(__file__).resolve().parent / "golden" / "naive_cmyk.icc"
    loaded = []
    real = io_color.load_image

    def load(path, proof_prof=None):
        loaded.append((np.asarray(real(path)), np.asarray(real(path, proof_prof))))
        return real(path, proof_prof)

    monkeypatch.setattr(tcli, "load_image", load)
    tcli.main(argv + ["--proof", str(proof), "--end-scale", "64", "--min-scale", "64",
                      "-i", "2", "-ii", "2", "--callback-chunk", "2"])
    assert len(loaded) == 2
    for plain, proofed in loaded:
        assert plain.shape == proofed.shape
        assert np.abs(plain.astype(int) - proofed.astype(int)).max() > 0
    with Image.open(trace.parent / "out.png") as img:
        assert img.size == (64, 48) and img.info.get("icc_profile") == io_color.srgb_profile
    assert [it["i"] for it in json.loads(trace.read_text())["iterates"]] == [1, 2]
