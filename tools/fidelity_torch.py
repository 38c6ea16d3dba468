"""One-command fidelity harness of the PyTorch port against reference outputs.

The port's counterpart of ``tools/fidelity.py``: it runs the same
BASELINE.json graded workloads (the same ``config_plan``) through
``style_transfer_tpu_torch.StyleTransfer`` on one torch device and reports
PSNR / SSIM / the perceptual distance (real LPIPS when a bundle resolves,
else the VGG-distance proxy, labeled) of the outputs against outputs
produced by the reference implementation, computed by the port's
``utils/metrics.py`` on the same device. The thresholds, the JSON lines and
the exit code are the JAX tool's. The reference outputs are named
``<config>.png`` under one directory (see ``tools/fidelity.py`` for the
reference commands). Pretrained weights: ``--vgg-weights`` (a ``.npz`` from
``tools/port_weights.py`` or the torchvision ``.pth``); with the random
fallback the metrics against reference outputs are meaningless, and the
tool says so.

Usage:
    python tools/fidelity_torch.py CONTENT STYLE [STYLE2 ...] \
        --reference DIR [--vgg-weights W.npz] [--configs c1,c2,...] \
        [--out DIR] [--end-scale 512] [--devices cuda:0]

Prints one JSON line per config plus a summary; exit 1 if any compared
config misses the thresholds (psnr < 20 or perceptual >= 0.02).
"""

import argparse
import json
import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

PSNR_FLOOR = 20.0
LPIPS_PROXY_CEIL = 0.02


def config_plan(args):
    """(name, constructor kwargs, stylize kwargs, needs_n_styles)."""
    end = args.end_scale
    plans = [
        ("c1_single256", {}, dict(min_scale=256, end_scale=256,
                                  iterations=500, initial_iterations=500), 1),
        ("c2_pyramid512", {}, dict(end_scale=end), 1),
        ("c3_multistyle", {}, dict(end_scale=end, style_weights=[2.0, 1.0]), 2),
        ("c4_gram", {"style_loss": "gram"}, dict(end_scale=end), 1),
        ("c4_avg", {"pooling": "average"}, dict(end_scale=end), 1),
        ("c4_l2", {"pooling": "l2"}, dict(end_scale=end), 1),
        ("c5_print", {}, dict(end_scale=2896), 1),
    ]
    if args.configs:
        want = {c.strip() for c in args.configs.split(",")}
        unknown = want - {name for name, *_ in plans}
        if unknown:
            sys.exit(f"unknown configs: {sorted(unknown)}")
        plans = [p for p in plans if p[0] in want]
    else:
        plans = [p for p in plans if p[0] != "c5_print"]  # opt-in (minutes)
    return plans


def build_parser():
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("content")
    p.add_argument("styles", nargs="+", metavar="style")
    p.add_argument("--reference", type=str, default=None,
                   help="directory of reference outputs (<config>.png), or a "
                        "single file when exactly one config is selected")
    p.add_argument("--vgg-weights", type=str, default=None)
    p.add_argument("--lpips-weights", type=str, default=None,
                   help="LPIPS bundle (.npz from tools/port_lpips.py); when "
                        "omitted, $STT_LPIPS_WEIGHTS and default locations "
                        "are searched: real LPIPS is reported whenever a "
                        "bundle resolves, the VGG-distance proxy otherwise")
    p.add_argument("--configs", type=str, default=None,
                   help="comma list (default: all but c5_print)")
    p.add_argument("--out", type=str, default="fidelity_out")
    p.add_argument("--end-scale", type=int, default=512)
    p.add_argument("--devices", type=str, default="cuda:0", metavar="DEVICE",
                   help="the torch device to run on and compute the metrics "
                        "on (e.g. cuda:0, cpu)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--iterations", type=int, default=None,
                   help="override per-scale (and initial) iterations, for "
                        "smoke-testing the harness itself")
    p.add_argument("--min-scale", type=int, default=None)
    return p


def _find_reference(ref_dir, name, n_plans):
    if ref_dir is None:
        return None
    if ref_dir.is_file() and n_plans == 1:
        return ref_dir
    for suffix in (".png", ".jpg", ".tiff", ".tif"):
        cand = ref_dir / f"{name}{suffix}"
        if cand.is_file():
            return cand
    return None


def main(argv=None):
    args = build_parser().parse_args(argv)

    from PIL import Image

    from style_transfer_tpu_torch.engine import StyleTransfer
    from style_transfer_tpu_torch.io_color import load_image
    from style_transfer_tpu_torch.utils.metrics import perceptual_distance, psnr, ssim

    content = load_image(args.content)
    styles = [load_image(s) for s in args.styles]
    out_dir = Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    ref_dir = Path(args.reference) if args.reference else None
    plans = config_plan(args)

    # The metrics use the run's own weights: with the random fallback the
    # perceptual distance against the reference means nothing, so say so.
    results, failed = [], []
    params = None
    for name, ctor_kw, sty_kw, needs in plans:
        if len(styles) < needs:
            print(json.dumps({"config": name, "skipped": "needs >=2 styles"}))
            continue
        st = StyleTransfer(device=args.devices, weights=args.vgg_weights, **ctor_kw)
        if params is None:
            params = st.params
            if "random" in st.weights_source:
                print("WARNING: running with RANDOM VGG weights — metrics "
                      "against reference outputs are meaningless. Pass "
                      "--vgg-weights.", file=sys.stderr)
        st.seed(args.seed)
        sk = dict(sty_kw)
        if needs == 1:
            sk.pop("style_weights", None)
        if args.iterations is not None:
            sk["iterations"] = sk["initial_iterations"] = args.iterations
        if args.min_scale is not None:
            sk["min_scale"] = args.min_scale
        img = st.stylize(content, styles[:needs], **sk)
        out_path = out_dir / f"{name}.png"
        img.save(out_path)

        rec = {"config": name, "output": str(out_path), "weights": st.weights_source}
        ref_path = _find_reference(ref_dir, name, len(plans))
        if ref_path is not None:
            ref = np.asarray(Image.open(ref_path).convert("RGB"), np.float64) / 255.0
            ours = np.asarray(img.convert("RGB"), np.float64) / 255.0
            if ref.shape != ours.shape:
                rec["error"] = f"shape mismatch: ref {ref.shape} vs ours {ours.shape}"
                failed.append(name)
            else:
                rec["psnr"] = round(psnr(ours, ref), 3)
                rec["ssim"] = round(ssim(ours, ref), 4)
                dist, kind = perceptual_distance(
                    ours, ref, params=params, lpips_weights=args.lpips_weights,
                    device=args.devices)
                rec["perceptual"] = round(dist, 5)
                rec["perceptual_metric"] = kind
                rec["pass"] = (rec["psnr"] >= PSNR_FLOOR
                               and rec["perceptual"] < LPIPS_PROXY_CEIL)
                if not rec["pass"]:
                    failed.append(name)
        else:
            rec["note"] = "no reference output found; generated only"
        results.append(rec)
        print(json.dumps(rec), flush=True)

    compared = [r for r in results if "pass" in r]
    print(json.dumps({
        "summary": {"run": len(results), "compared": len(compared),
                    "passed": sum(r["pass"] for r in compared),
                    "thresholds": {"psnr_min": PSNR_FLOOR,
                                   "perceptual_max": LPIPS_PROXY_CEIL}},
    }))
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
