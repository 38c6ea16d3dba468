"""Command-line interface of the PyTorch port.

Port of ``style_transfer_tpu/cli.py`` for the Adam and reference L-BFGS
pyramids with either W2 gradient: the reference flag surface that the port
implements, with engine hyperparameter flags
taking their defaults and types from ``StyleTransfer.stylize``'s keyword
defaults/annotations, so CLI and engine cannot drift. ``--devices`` names one
torch device (default ``cuda:0``; ``cpu`` when named). ``--profile DIR``
records a ``torch.profiler`` trace of the run into DIR.

    style-transfer-tpu-torch content.jpg style.jpg -o out.png
"""

import argparse
import contextlib
import os
import sys
from pathlib import Path

from .io_color import load_image, print_error, save_image
from .utils.scales import get_safe_scale
from .utils.trace import TraceRecorder

__doc_short__ = "Neural style transfer in PyTorch (CUDA), W2/Gram losses over VGG-19."


class Callback:
    """Per-iteration progress: tqdm line, periodic saves, trace.

    Behavior parity with reference cli.py:107-140: the image is saved every
    ``--save-every`` iterations and at the end of every scale but the last
    (``main`` writes the final one)."""

    def __init__(self, st, args, image_type="pil"):
        self.st = st
        self.args = args
        self.image_type = image_type
        self.recorder = TraceRecorder(args)
        self.progress = None

    def _save(self):
        try:
            save_image(self.args.output, self.st.get_image(self.image_type))
        except (OSError, ValueError) as err:
            print_error(err)

    def __call__(self, iterate):
        from tqdm import tqdm

        self.recorder.append(iterate)
        if iterate.i == 1 or self.progress is None:
            self.progress = tqdm(
                total=iterate.i_max, initial=iterate.i - 1, dynamic_ncols=True)
        msg = "Size: {}x{}, iteration: {}, loss: {:g}"
        tqdm.write(msg.format(iterate.w, iterate.h, iterate.i, iterate.loss))
        self.progress.update()
        if iterate.i == iterate.i_max:
            self.progress.close()
            self.progress = None
            if (iterate.w, iterate.h) != tuple(self.args.final_dims):
                self._save()
        elif iterate.i % self.args.save_every == 0:
            self._save()

    def close(self):
        if self.progress is not None:
            self.progress.close()
            self.progress = None


def build_parser(stylize_fn):
    p = argparse.ArgumentParser(
        description=__doc_short__,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )

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
    p.add_argument("--devices", type=str, default="cuda:0", metavar="DEVICE",
                   help="the torch device to run on (e.g. cuda:0, cpu)")
    p.add_argument("--random-seed", "-r", type=int, default=0, help="the random seed")
    p.add_argument("--content-weight", "-cw", **arg_info("content_weight"),
                   help="the content weight")
    p.add_argument("--tv-weight", "-tw", **arg_info("tv_weight"),
                   help="the smoothing weight")
    p.add_argument("--optimizer", **arg_info("optimizer"),
                   choices=["adam", "lbfgs"],
                   help="the optimizer to use (lbfgs = the reference's "
                        "fixed-step flavor)")
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
    p.add_argument("--style-loss", type=str, default="w2", choices=["w2", "gram"],
                   help="style objective: Wasserstein-2 or Gram matrix")
    p.add_argument("--content-loss", type=str, default="mse",
                   choices=["mse", "scaled"],
                   help="content objective: plain MSE (reference default) or "
                        "gradient-normalized ScaledMSE")
    p.add_argument("--w2-grad", type=str, default="trace",
                   choices=["trace", "lyap"],
                   help="W2 sqrt-term gradient: analytic trace VJP (exact, "
                        "faster) or the reference's iterative Lyapunov "
                        "backward")
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
    return p


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

    p = build_parser(StyleTransfer.stylize)
    args = p.parse_args(argv)

    try:
        content_img = load_image(args.content, args.proof)
        style_imgs = [load_image(img, args.proof) for img in args.styles]
    except OSError as err:
        print_error(err)
        sys.exit(1)

    image_type = "pil"
    if Path(args.output).suffix.lower() in {".tif", ".tiff"}:
        image_type = "np_uint16"

    try:
        device = _resolve_device(args.devices)
    except RuntimeError as err:
        print_error(err)
        sys.exit(1)
    print("Using device:", device)
    print_hardware_banner(device)

    end_scale = int(str(args.end_scale).rstrip("+"))
    if str(args.end_scale).endswith("+"):
        end_scale = get_safe_scale(*content_img.size, end_scale)
    args.end_scale = end_scale

    print("Loading model...")
    st = StyleTransfer(
        device=device,
        pooling=args.pooling,
        weights=args.vgg_weights,
        style_loss=args.style_loss,
        content_loss=args.content_loss,
        w2_grad=args.w2_grad,
        callback_chunk=args.callback_chunk,
    )
    st.seed(args.random_seed)
    # The final canvas, used by the callback to detect the last scale.
    args.final_dims = st.canvas(content_img.size, args.end_scale, args.align)
    print(f"VGG-19 weights: {st.weights_source}")

    callback = Callback(st, args, image_type=image_type)
    defaults = StyleTransfer.stylize.__kwdefaults__
    st_kwargs = {k: v for k, v in args.__dict__.items() if k in defaults}
    profile_cm = (_profiler(args.profile, device) if args.profile
                  else contextlib.nullcontext())
    try:
        with profile_cm:
            st.stylize(content_img, style_imgs, **st_kwargs, callback=callback)
    except KeyboardInterrupt:
        pass
    finally:
        callback.close()

    output_image = st.get_image(image_type)
    if output_image is not None:
        try:
            save_image(args.output, output_image)
        except (OSError, ValueError) as err:
            print_error(err)
            sys.exit(1)
    callback.recorder.write(args.trace)


if __name__ == "__main__":
    main()
