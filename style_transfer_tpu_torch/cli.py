"""Command-line interface of the PyTorch port.

Port of ``style_transfer_tpu/cli.py`` for the Adam, reference L-BFGS and
zoom L-BFGS pyramids with either W2 gradient: the reference flag surface
that the port implements, with engine hyperparameter flags
taking their defaults and types from ``StyleTransfer.stylize``'s keyword
defaults/annotations, so CLI and engine cannot drift. ``--devices`` takes
the JAX CLI's three forms: a count of CUDA devices, ``all``, or device names
(default ``cuda:0``; ``cpu`` when named). With more than one device the
image is sharded over them, one process per device (``parallel/``); a name
given twice (``cuda:0 cuda:0``, ``cpu cpu``) puts two ranks on one device.
Started by torchrun, the CLI runs as that rank on ``cuda:LOCAL_RANK`` (or
the CPU when ``--devices`` names it) and starts nothing. ``--profile DIR``
records a ``torch.profiler`` trace of the run into DIR. Mid-run image saves
run on a writer thread; ``--checkpoint``/``--resume`` continue an
interrupted run; ``--web`` serves a live preview; ``--precision bf16`` runs
the VGG trunk in bf16; ``--remat`` rematerialises it in the backward
(``auto``: where the card would not hold the step without it). The trace
records each scale's choice under ``remat`` and, on one device, the NS
kernels' launches under ``kernel_launches``.

    style-transfer-tpu-torch content.jpg style.jpg -o out.png
    style-transfer-tpu-torch content.jpg style.jpg --devices 2
    torchrun --nproc-per-node 2 -m style_transfer_tpu_torch.cli content.jpg style.jpg
"""

import argparse
import atexit
import contextlib
import json
import os
import sys
import threading
import webbrowser
from pathlib import Path

from .io_color import load_image, print_error, save_image
from .utils.scales import get_safe_scale
from .utils.trace import TraceRecorder, peak_device_ram

__doc_short__ = "Neural style transfer in PyTorch (CUDA), W2/Gram losses over VGG-19."


class _AsyncImageSaver:
    """Background writer for mid-run image saves (single slot, latest wins).

    The payload is a device tensor from ``StyleTransfer.get_image_device``,
    a fresh tensor the run never writes: its device-to-host fetch, the
    encode and the disk write all run on this thread, off the iteration
    loop."""

    def __init__(self):
        self._cond = threading.Condition()
        self._pending = None
        self._busy = False
        threading.Thread(target=self._run, name="stt-save", daemon=True).start()

    def _run(self):
        from .engine import tensor_to_image

        while True:
            with self._cond:
                while self._pending is None:
                    self._cond.wait()
                path, image, image_type = self._pending
                self._pending = None
                self._busy = True
            try:
                if not hasattr(image, "save") and image_type is not None:
                    image = tensor_to_image(image, image_type)
                save_image(path, image)
            except (OSError, ValueError) as err:
                print_error(err)
            finally:
                del image  # release the device tensor now
            with self._cond:
                self._busy = False
                self._cond.notify_all()

    def submit(self, path, image, image_type=None):
        with self._cond:
            self._pending = (path, image, image_type)
            self._cond.notify_all()

    def flush(self):
        with self._cond:
            while self._pending is not None or self._busy:
                self._cond.wait()


class Callback:
    """Per-iteration progress: tqdm line, periodic saves, web events, trace.

    Behavior parity with reference cli.py:107-140: the image is saved every
    ``--save-every`` iterations and at the end of every scale but the last
    (``main`` writes the final one, synchronously after a flush, so the
    output on disk is never stale). Mid-run saves are asynchronous."""

    def __init__(self, st, args, image_type="pil", web_interface=None):
        self.st = st
        self.args = args
        self.image_type = image_type
        self.web_interface = web_interface
        self.recorder = TraceRecorder(args)
        self.progress = None
        self.saver = _AsyncImageSaver()

    def _is_final_scale(self, iterate):
        # The aligned final canvas, not the raw end_scale: with --align the
        # final dims need not equal end_scale.
        final = getattr(self.args, "final_dims", None)
        if final is not None:
            return (iterate.w, iterate.h) == tuple(final)
        return max(iterate.w, iterate.h) == self.args.end_scale

    def _save(self):
        self.saver.submit(self.args.output, self.st.get_image_device(),
                          self.image_type)

    def __call__(self, iterate):
        from tqdm import tqdm

        self.recorder.append(iterate)
        if iterate.i == 1 or self.progress is None:
            # Lazy creation also covers resumed runs, whose first callback
            # arrives mid-scale with i > 1.
            self.progress = tqdm(
                total=iterate.i_max, initial=iterate.i - 1, dynamic_ncols=True)
        msg = "Size: {}x{}, iteration: {}, loss: {:g}"
        tqdm.write(msg.format(iterate.w, iterate.h, iterate.i, iterate.loss))
        self.progress.update()
        if self.web_interface is not None:
            self.web_interface.put_iterate(iterate, self.st.get_image_tensor())
        if iterate.i == iterate.i_max:
            self.progress.close()
            self.progress = None
            if not self._is_final_scale(iterate):
                self._save()
            elif self.web_interface is not None:
                self.web_interface.put_done()
        elif iterate.i % self.args.save_every == 0:
            self._save()

    def close(self):
        self.saver.flush()
        if self.progress is not None:
            self.progress.close()
            self.progress = None

    def get_trace(self):
        return self.recorder.get_trace()


def build_parser(stylize_fn):
    p = argparse.ArgumentParser(
        description=__doc_short__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

    from .step import OPTIMIZERS

    defaults = stylize_fn.__kwdefaults__
    types = stylize_fn.__annotations__

    def arg_info(name):
        return {"default": defaults[name], "type": types[name]}

    p.add_argument("content", type=str, help="the content image")
    p.add_argument("styles", type=str, nargs="+", metavar="style",
                   help="the style images")
    p.add_argument("--output", "-o", type=str, default="out.png",
                   help="the output image")
    p.add_argument("--style-weights", "-sw", type=float, nargs="+", default=None,
                   metavar="STYLE_WEIGHT",
                   help="the relative weights for each style image")
    p.add_argument("--devices", type=str, nargs="+", default=["cuda:0"],
                   metavar="DEVICE",
                   help="the devices to shard the image over: a CUDA device "
                        "count, 'all', or torch device names (e.g. cuda:0 "
                        "cuda:1, cpu); a name given twice puts two ranks on "
                        "one device")
    p.add_argument("--random-seed", "-r", type=int, default=0, help="the random seed")
    p.add_argument("--content-weight", "-cw", **arg_info("content_weight"),
                   help="the content weight")
    p.add_argument("--tv-weight", "-tw", **arg_info("tv_weight"),
                   help="the smoothing weight")
    p.add_argument("--optimizer", **arg_info("optimizer"),
                   choices=list(OPTIMIZERS),
                   help="the optimizer to use (lbfgs = the reference's "
                        "fixed-step flavor; lbfgs-zoom adds a zoom "
                        "linesearch)")
    p.add_argument("--min-scale", "-ms", **arg_info("min_scale"),
                   help="the minimum scale (max image dim), in pixels")
    p.add_argument("--end-scale", "-s", type=str, default="512",
                   help="the final scale (max image dim), in pixels; append + "
                        "to cap total pixels for non-square images")
    p.add_argument("--iterations", "-i", **arg_info("iterations"),
                   help="the number of iterations per scale")
    p.add_argument("--initial-iterations", "-ii", **arg_info("initial_iterations"),
                   help="the number of iterations on the first scale")
    p.add_argument("--save-every", type=int, default=50,
                   help="save the image every SAVE_EVERY iterations")
    p.add_argument("--step-size", "-ss", **arg_info("step_size"),
                   help="the step size (learning rate) for Adam")
    p.add_argument("--avg-decay", "-ad", **arg_info("avg_decay"),
                   help="the EMA decay rate for iterate averaging")
    p.add_argument("--init", **arg_info("init"),
                   choices=["content", "gray", "uniform", "normal", "style_stats"],
                   help="the initial image")
    p.add_argument("--style-scale-fac", **arg_info("style_scale_fac"),
                   help="the relative scale of the style to the content")
    p.add_argument("--style-size", **arg_info("style_size"),
                   help="the fixed scale of the style at different content scales")
    p.add_argument("--pooling", type=str, default="max",
                   choices=["max", "average", "l2"], help="the model's pooling mode")
    p.add_argument("--proof", type=str, default=None,
                   help="the ICC color profile (CMYK) for soft proofing the "
                        "content and styles")
    p.add_argument("--web", default=False, action="store_true",
                   help="enable the web interface")
    p.add_argument("--host", type=str, default="0.0.0.0",
                   help="the host the web interface binds to")
    p.add_argument("--port", type=int, default=8080,
                   help="the port the web interface binds to")
    p.add_argument("--browser", type=str, default="", nargs="?",
                   help="open a web browser (specify the browser if not "
                        "system default)")
    p.add_argument("--style-loss", type=str, default="w2", choices=["w2", "gram"],
                   help="style objective: Wasserstein-2 or Gram matrix")
    p.add_argument("--content-loss", type=str, default="mse",
                   choices=["mse", "scaled"],
                   help="content objective: plain MSE (reference default) or "
                        "gradient-normalized ScaledMSE")
    p.add_argument("--precision", type=str, default="auto",
                   choices=["auto", "bf16", "f32"],
                   help="VGG trunk precision (auto = f32; the statistics and "
                        "the matrix square roots stay f32)")
    p.add_argument("--w2-grad", type=str, default="trace",
                   choices=["trace", "lyap"],
                   help="W2 sqrt-term gradient: analytic trace VJP (exact, "
                        "faster) or the reference's iterative Lyapunov "
                        "backward")
    p.add_argument("--remat", type=str, default="auto",
                   choices=["auto", "on", "off"],
                   help="rematerialize the trunk in backward (memory vs compute)")
    p.add_argument("--vgg-weights", type=str, default=None,
                   help="path to VGG-19 weights (.npz native or torchvision .pth)")
    p.add_argument("--align", **arg_info("align"),
                   help="round optimization dims to a multiple (default: exact "
                        "reference sizing)")
    p.add_argument("--callback-chunk", type=int, default=50,
                   help="iterations per host sync")
    p.add_argument("--trace", type=str, default="trace.json",
                   help="where to write the run trace")
    p.add_argument("--profile", type=str, default=None, metavar="DIR",
                   help="record a torch.profiler trace of the run into DIR")
    p.add_argument("--checkpoint", **arg_info("checkpoint"),
                   help="path to write full optimization-state checkpoints")
    p.add_argument("--checkpoint-every", **arg_info("checkpoint_every"),
                   help="iterations between checkpoint writes (scale ends "
                        "always checkpoint; writes are asynchronous)")
    p.add_argument("--resume", default=False, action="store_true",
                   help="resume from --checkpoint if it exists")
    return p


def _resolve_devices(spec):
    """``--devices`` -> a list of torch devices: a count (the first N CUDA
    devices), 'all' (every CUDA device) or names, all of one type."""
    import torch

    if len(spec) == 1 and (spec[0] == "all" or spec[0].isdigit()):
        count = torch.cuda.device_count() if torch.cuda.is_available() else 0
        n = count if spec[0] == "all" else int(spec[0])
        if not 1 <= n <= count:
            raise RuntimeError(f"requested {spec[0]} CUDA devices but {count} available")
        return [torch.device("cuda", i) for i in range(n)]
    devices = [_resolve_device(name) for name in spec]
    if len({d.type for d in devices}) > 1:
        raise RuntimeError("devices must all be of one type")
    return devices


def _resolve_device(name):
    import torch

    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {name!r} requested but CUDA is not available")
    if device.type == "cuda":
        index = device.index or 0
        if index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {name!r} requested but only "
                f"{torch.cuda.device_count()} CUDA devices exist")
        device = torch.device("cuda", index)
    return device


def print_hardware_banner(device):
    import torch

    print(f"CPU threads: {os.cpu_count()}")
    if device.type == "cuda":
        props = torch.cuda.get_device_properties(device)
        print(f"Device {device}: {props.name} "
              f"({props.total_memory / 2**30:.2f} GB memory)")
    else:
        print(f"Device {device}")


def _profiler(out_dir, device):
    """torch.profiler over the run; the Chrome trace lands in ``out_dir``."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    Path(out_dir).mkdir(parents=True, exist_ok=True)

    def on_ready(prof):
        prof.export_chrome_trace(str(Path(out_dir) / "torch_trace.json"))

    return torch.profiler.profile(activities=acts, on_trace_ready=on_ready)


def main(argv=None):
    from .engine import StyleTransfer  # deferred: torch import
    from .parallel import multihost

    p = build_parser(StyleTransfer.stylize)
    args = p.parse_args(argv)

    try:
        devices = _resolve_devices(args.devices)
    except RuntimeError as err:
        print_error(err)
        sys.exit(1)
    if multihost.initialize(devices[0].type):
        from .parallel.mesh import make_mesh

        _rank_run(make_mesh(multihost.local_device(devices[0].type)), args)
    elif len(devices) > 1:
        import torch.multiprocessing as mp

        from .parallel.launch import launch

        if len(set(devices)) < len(devices):
            print("Ranks share a device: this run checks the sharded path's "
                  "function, not its speed.")
        try:
            launch(_rank_run, devices, (args,))
        except (mp.ProcessRaisedException, mp.ProcessExitedException) as err:
            print_error(err)
            sys.exit(1)
    else:
        _run(args, devices[0])


def _rank_run(mesh, args):
    """One rank of a sharded run; ranks other than 0 print nothing."""
    out = sys.stdout if mesh.rank == 0 else open(os.devnull, "w")
    try:
        with contextlib.redirect_stdout(out):
            _run(args, mesh.device, mesh)
    finally:
        if out is not sys.stdout:
            out.close()


def _kernel_launches():
    """This process's launches of the NS kernels so far."""
    from .ops.cuda import ns_sqrtm as K

    return {k: getattr(K, k).launches for k in ("ns_sqrtm_yz", "ns_sqrtm", "lyap_bwd")}


def _rank_report(mesh, st):
    """Every rank's device, peak memory, kernel launches and time in the
    halo exchanges and all-reduces, gathered for rank 0's trace."""
    import torch.distributed as dist

    stats = mesh.stats
    mine = {
        "rank": mesh.rank, "device": str(mesh.device), "grid": list(mesh.grid),
        "backend": mesh.backend,
        "peak_memory": peak_device_ram(st.device),
        "kernel_launches": _kernel_launches(),
        "halo_s": stats.halo_s, "halo_calls": stats.halo_calls,
        "reduce_s": stats.reduce_s, "reduce_calls": stats.reduce_calls,
    }
    ranks = [None] * mesh.world
    dist.all_gather_object(ranks, mine)
    return ranks


def _run(args, device, mesh=None):
    """The run on one device, or as one rank of a sharded run (``mesh``):
    only rank 0 prints, serves the preview, profiles and writes files."""
    from .engine import StyleTransfer

    rank0 = mesh is None or mesh.rank == 0
    try:
        content_img = load_image(args.content, args.proof)
        style_imgs = [load_image(img, args.proof) for img in args.styles]
    except OSError as err:
        print_error(err)
        sys.exit(1)

    image_type = "pil"
    if Path(args.output).suffix.lower() in {".tif", ".tiff"}:
        image_type = "np_uint16"

    print("Using device:", device)
    if mesh is not None:
        print(f"Rank {mesh.rank} of {mesh.world} ({mesh.grid[0]}x{mesh.grid[1]} grid, "
              f"{mesh.backend} backend)")
    print_hardware_banner(device)

    end_scale = int(str(args.end_scale).rstrip("+"))
    if str(args.end_scale).endswith("+"):
        end_scale = get_safe_scale(*content_img.size, end_scale)
    args.end_scale = end_scale

    web_interface = None
    if args.web and rank0:
        from .web.server import WebInterface

        # Raises when the server cannot start: a run asked for a preview
        # never goes on without one.
        web_interface = WebInterface(args.host, args.port)
        atexit.register(web_interface.close)

    print("Loading model...")
    st = StyleTransfer(
        device=device,
        pooling=args.pooling,
        weights=args.vgg_weights,
        style_loss=args.style_loss,
        content_loss=args.content_loss,
        w2_grad=args.w2_grad,
        compute_dtype=args.precision,
        callback_chunk=args.callback_chunk,
        remat={"auto": None, "on": True, "off": False}[args.remat],
        mesh=mesh,
    )
    st.seed(args.random_seed)
    # The final canvas, used by the callback to detect the last scale.
    args.final_dims = st.canvas(content_img.size, args.end_scale, args.align)
    print(f"VGG-19 weights: {st.weights_source}")

    callback = (Callback(st, args, image_type=image_type, web_interface=web_interface)
                if rank0 else None)
    if web_interface is not None:
        url = f"http://{args.host}:{args.port}/"
        if args.browser:
            webbrowser.get(args.browser).open(url)
        elif args.browser is None:
            webbrowser.open(url)
    defaults = StyleTransfer.stylize.__kwdefaults__
    st_kwargs = {k: v for k, v in args.__dict__.items() if k in defaults}
    profile_cm = (_profiler(args.profile, device) if args.profile and rank0
                  else contextlib.nullcontext())
    try:
        with profile_cm:
            st.stylize(content_img, style_imgs, **st_kwargs, callback=callback)
    except KeyboardInterrupt:
        pass
    finally:
        # Drains the in-flight async save first, so it cannot land after
        # (and clobber) the final image written below.
        if callback is not None:
            callback.close()
        if web_interface is not None:
            web_interface.close()

    trace = callback.get_trace() if rank0 else None
    if rank0:
        trace["remat"] = st.remat_scales
    if mesh is None:
        trace["kernel_launches"] = _kernel_launches()
    if mesh is not None:
        ranks = _rank_report(mesh, st)
        if rank0:
            trace["ranks"] = ranks
    if not rank0:
        return
    output_image = st.get_image(image_type)
    if output_image is not None:
        try:
            save_image(args.output, output_image)
        except (OSError, ValueError) as err:
            print_error(err)
            sys.exit(1)
    with open(args.trace, "w") as fp:
        json.dump(trace, fp, indent=4)


if __name__ == "__main__":
    main()
