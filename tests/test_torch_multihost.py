"""PyTorch port: starting a sharded run, on the CPU.

torchrun's environment (``parallel/multihost.py``), the launcher's failure
handling (``parallel/launch.py``), ``--devices`` and the sharded CLI with
its checkpoints: ``--devices cpu cpu`` runs two gloo ranks.
"""

import json
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from PIL import Image

import style_transfer_tpu_torch as T
from style_transfer_tpu.models.weights import random_params
from style_transfer_tpu_torch import cli as tcli
from style_transfer_tpu_torch.parallel import checks, multihost
from style_transfer_tpu_torch.parallel.launch import launch
from style_transfer_tpu_torch.parallel.mesh import pick_backend

torch.set_num_threads(2)


def test_initialize_is_a_noop_without_torchrun(monkeypatch):
    for var in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    assert multihost.initialize() is False
    assert multihost.is_multihost() is False
    assert multihost.local_device_count() >= 1
    assert multihost.local_device("cpu") == torch.device("cpu")


def test_devices_forms_and_backend():
    assert tcli._resolve_devices(["cpu"]) == [torch.device("cpu")]
    assert tcli._resolve_devices(["cpu", "cpu"]) == [torch.device("cpu")] * 2
    # Counts and 'all' name CUDA devices, which this machine has none of.
    for spec in (["2"], ["all"], ["0"]):
        with pytest.raises(RuntimeError, match="CUDA devices"):
            tcli._resolve_devices(spec)
    assert pick_backend(["cpu", "cpu"]) == "gloo"
    assert pick_backend(["cuda:0", "cuda:1"]) == "nccl"
    assert pick_backend(["cuda:0", "cuda:0"]) == "gloo"  # NCCL refuses a shared card
    parser = tcli.build_parser(T.StyleTransfer.stylize)
    assert parser.parse_args(["c", "s"]).devices == ["cuda:0"]
    assert parser.parse_args(["c", "s", "--devices", "cuda:0", "cuda:0"]).devices == [
        "cuda:0", "cuda:0"]


def test_a_failing_rank_ends_the_run(capfd):
    """Rank 1 raises while rank 0 waits for it in a collective: the launcher
    ends rank 0 and raises, within a bounded time, without retrying, and
    rank 1's own error is printed (the raised one may be rank 0's lost
    connection)."""
    t0 = time.perf_counter()
    with pytest.raises(mp.ProcessRaisedException):
        launch(checks.fail_on_rank, ["cpu", "cpu"], (1,), timeout_s=120)
    assert time.perf_counter() - t0 < 60
    err = capfd.readouterr().err
    assert "rank 1 of 2 failed" in err and "rank 1 failed on purpose" in err


def _losses(trace):
    return np.array([it["loss"] for it in json.loads(trace.read_text())["iterates"]])


def test_sharded_cli_pyramid_and_checkpoints(tmp_path, content_pil, style_pil):
    """``--devices cpu cpu`` over the two-scale pyramid 64 -> 96 px (68x51,
    96x72) with a 16-bit TIFF output and checkpoints: the output is whole,
    16/16/16 bits with the ICC profile; the losses equal the one-device
    run's to rtol 1e-5; a checkpoint written by 2 ranks at the end of the
    first scale resumes on one device, and one written on one device
    resumes on 2 ranks, each agreeing with the uninterrupted runs."""
    content, style, weights = tmp_path / "c.png", tmp_path / "s.png", tmp_path / "w.npz"
    content_pil.save(content)  # 128x96
    style_pil.save(style)
    np.savez(weights, **random_params(0))

    def run(name, devices, end_scale, *flags):
        trace = tmp_path / f"{name}.json"
        tcli.main([str(content), str(style), "--vgg-weights", str(weights),
                   "--devices", *devices, "--min-scale", "64", "--end-scale",
                   str(end_scale), "-i", "3", "-ii", "3", "--trace", str(trace),
                   "-o", str(tmp_path / f"{name}.tif"), *flags])
        return trace

    one = run("one", ["cpu"], 96)
    two = run("two", ["cpu", "cpu"], 96, "--checkpoint", str(tmp_path / "two.npz"))
    t = json.loads(two.read_text())
    assert [(it["w"], it["h"], it["i"]) for it in t["iterates"]] == [
        (68, 51, 1), (68, 51, 2), (68, 51, 3), (96, 72, 1), (96, 72, 2), (96, 72, 3)]
    assert [r["rank"] for r in t["ranks"]] == [0, 1]
    assert all(r["grid"] == [2, 1] and r["halo_calls"] > 0 and r["reduce_calls"] > 0
               for r in t["ranks"])
    np.testing.assert_allclose(_losses(two), _losses(one), rtol=1e-5)
    with Image.open(tmp_path / "two.tif") as img:
        assert img.size == (96, 72)
        assert tuple(img.tag_v2[258]) == (16, 16, 16)  # BitsPerSample
        assert "icc_profile" in img.info
    assert (tmp_path / "two.npz").is_file()

    # 2 ranks -> one device, and one device -> 2 ranks, from the end of the
    # first scale (a checkpoint at the end of a run of that scale alone).
    for first, then in ((["cpu", "cpu"], ["cpu"]), (["cpu"], ["cpu", "cpu"])):
        ck = tmp_path / f"ck{len(first)}.npz"
        run("first", first, 68, "--checkpoint", str(ck))
        resumed = run("resumed", then, 96, "--checkpoint", str(ck), "--resume")
        its = json.loads(resumed.read_text())["iterates"]
        assert [(it["w"], it["i"]) for it in its] == [(96, 1), (96, 2), (96, 3)]
        np.testing.assert_allclose(_losses(resumed), _losses(one)[3:], rtol=1e-5)
        np.testing.assert_allclose(_losses(resumed), _losses(two)[3:], rtol=1e-5)


def test_an_interrupting_callback_stops_every_rank_after_the_same_chunk(tmp_path):
    """One 2-rank launch runs the 64 -> 96 px pyramid three times: whole;
    with checkpoints every 10 iterations and rank 0's callback raising
    KeyboardInterrupt at iteration 10 of the second scale (chunks of 5); and
    resumed from that checkpoint. Every rank leaves the interrupted
    ``stylize`` after the same chunk, and the resumed losses equal the whole
    run's from the resume point. A rank that went on alone would wait in a
    collective until the group's 30 s timeout ended the launch."""
    pyramid = dict(min_scale=64, end_scale=96, initial_iterations=5, iterations=15)
    ck = dict(checkpoint="ck.npz", checkpoint_every=10)
    runs = [pyramid, {**pyramid, **ck, "stop_at": (1, 10)},
            {**pyramid, **ck, "resume": True}]
    launch(checks.stylize_ranks, ["cpu", "cpu"], (runs, str(tmp_path)), timeout_s=30)
    whole, cut, resumed = ([dict(np.load(tmp_path / f"run{j}_rank{r}.npz")) for r in range(2)]
                           for j in range(3))
    assert [r["stopped"] for r in cut] == [True, True]
    assert not any(r["stopped"] for r in whole + resumed)
    np.testing.assert_array_equal(cut[0]["accum"], cut[1]["accum"])
    np.testing.assert_array_equal(cut[0]["hw"], cut[1]["hw"])
    assert tuple(cut[0]["hw"]) == (72, 96, 3)
    assert cut[0]["its"][-1].tolist() == [96, 72, 10]
    # The chunk ended at iteration 10: the EMA counts the scale's 10 steps
    # past its seed, as the whole run does there.
    np.testing.assert_allclose(cut[0]["accum"], np.float32(0.99) ** 11, rtol=1e-6)
    assert resumed[0]["its"].tolist() == [[96, 72, i] for i in range(11, 16)]
    np.testing.assert_allclose(resumed[0]["losses"], whole[0]["losses"][-5:], rtol=1e-5)
    np.testing.assert_allclose(cut[0]["losses"], whole[0]["losses"][:15], rtol=1e-5)


def test_sigint_stops_a_sharded_cli_run_with_its_output(tmp_path, content_pil, style_pil):
    """The CLI with ``--devices cpu cpu`` as a subprocess in its own session;
    once its first checkpoint exists, SIGINT goes to its process group, as a
    terminal's Ctrl-C does. It exits 0 within 60 s, with the output image
    and ``trace.json`` (the ranks' report in it), its last iterate before
    the end of the run."""
    import os
    import signal
    import subprocess
    import sys
    from pathlib import Path

    content, style, weights = tmp_path / "c.png", tmp_path / "s.png", tmp_path / "w.npz"
    content_pil.save(content)
    style_pil.save(style)
    np.savez(weights, **random_params(0))
    out, trace, ck = tmp_path / "out.png", tmp_path / "trace.json", tmp_path / "ck.npz"
    repo = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=str(repo))
    argv = [sys.executable, "-m", "style_transfer_tpu_torch.cli", str(content), str(style),
            "--devices", "cpu", "cpu", "--vgg-weights", str(weights), "--min-scale", "64",
            "--end-scale", "96", "-ii", "10", "-i", "1000", "--callback-chunk", "5",
            "--checkpoint", str(ck), "--checkpoint-every", "10", "-o", str(out),
            "--trace", str(trace)]
    proc = subprocess.Popen(argv, cwd=tmp_path, env=env, start_new_session=True,
                            stdout=subprocess.DEVNULL, stderr=subprocess.PIPE)
    try:
        deadline = time.monotonic() + 300
        while not ck.exists() and proc.poll() is None and time.monotonic() < deadline:
            time.sleep(0.1)
        assert ck.exists(), proc.stderr.read().decode() if proc.poll() is not None else ""
        os.killpg(proc.pid, signal.SIGINT)
        t0 = time.monotonic()
        rc = proc.wait(timeout=60)
        assert time.monotonic() - t0 < 60
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    err = proc.stderr.read().decode()
    assert rc == 0, err
    with Image.open(out) as img:
        assert img.size == (96, 72)
    t = json.loads(trace.read_text())
    assert [r["rank"] for r in t["ranks"]] == [0, 1]
    last = t["iterates"][-1]
    assert (last["w"], last["h"]) == (96, 72) and last["i"] < last["i_max"] == 1000
    assert last["i"] % 5 == 0  # the ranks stopped at a chunk's end
