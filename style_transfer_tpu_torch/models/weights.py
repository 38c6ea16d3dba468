"""VGG-19 weight management: local .npz store, torchvision converter, fallback.

Port of ``style_transfer_tpu/models/weights.py``. Weights resolve from local
files, in this order:

1. an explicit path passed by the caller / ``--vgg-weights`` flag,
2. ``$STT_VGG19_NPZ`` (the native .npz format, HWIO kernels),
3. ``~/.cache/style_transfer_tpu/vgg19.npz``,
4. a torchvision checkpoint (``vgg19-*.pth``) found in the torch hub cache,
   converted on the fly (OIHW -> HWIO),
5. deterministic He-initialized random weights (loud warning).

The native format is shared with the JAX package: ``.npz`` with keys
``conv{i}_kernel`` (HWIO f32) and ``conv{i}_bias`` for each torchvision
features-index ``i`` in CONV_INDICES. Everything here stays numpy and HWIO;
:func:`params_from_jax` turns such a dict into the OIHW torch tensors the
trunk (``models/vgg.py``) convolves with.
"""

import os
import sys
import warnings
from pathlib import Path

import numpy as np
import torch

__all__ = [
    "CONV_INDICES",
    "CONV_CHANNELS",
    "POOL_INDICES",
    "load_params",
    "save_params",
    "random_params",
    "convert_torchvision",
    "resolve_params",
    "params_from_jax",
]

# torchvision vgg19().features indices of the conv layers, and their
# (in_channels, out_channels). Layer numbering matches torchvision's features
# indices, so layer configs mean the same as in the reference
# ([1,6,11,20,29] style, [22] content).
CONV_INDICES = (0, 2, 5, 7, 10, 12, 14, 16, 19, 21, 23, 25, 28, 30, 32, 34)
_CH = (3, 64, 64, 128, 128, 256, 256, 256, 256, 512, 512, 512, 512, 512, 512, 512, 512)
CONV_CHANNELS = {idx: (_CH[k], _CH[k + 1]) for k, idx in enumerate(CONV_INDICES)}
POOL_INDICES = (4, 9, 18, 27, 36)

_CACHE_PATH = Path("~/.cache/style_transfer_tpu/vgg19.npz").expanduser()


def random_params(seed: int = 0):
    """Deterministic He-normal random VGG-19 parameters (f32, HWIO numpy).

    The same RandomState draws in the same order as the JAX package, so
    ``random_params(0)`` gives identical networks in both packages.
    """
    rng = np.random.RandomState(seed)
    params = {}
    for idx in CONV_INDICES:
        cin, cout = CONV_CHANNELS[idx]
        fan_in = 3 * 3 * cin
        std = np.sqrt(2.0 / fan_in)
        params[f"conv{idx}_kernel"] = rng.normal(0.0, std, (3, 3, cin, cout)).astype(
            np.float32
        )
        params[f"conv{idx}_bias"] = np.zeros((cout,), np.float32)
    return params


def save_params(params, path):
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **{k: np.asarray(v) for k, v in params.items()})


def load_params(path):
    """Load the native .npz format; validates shapes."""
    with np.load(path) as f:
        params = {k: f[k] for k in f.files}
    _validate(params, path)
    return params


def _validate(params, origin):
    for idx in CONV_INDICES:
        cin, cout = CONV_CHANNELS[idx]
        k = params.get(f"conv{idx}_kernel")
        b = params.get(f"conv{idx}_bias")
        if k is None or b is None:
            raise ValueError(f"{origin}: missing weights for conv layer {idx}")
        if k.shape != (3, 3, cin, cout) or b.shape != (cout,):
            raise ValueError(
                f"{origin}: conv{idx} has shape {k.shape}/{b.shape}, "
                f"expected {(3, 3, cin, cout)}/{(cout,)}"
            )


def convert_torchvision(pth_path, out_path=None):
    """Convert a torchvision VGG-19 checkpoint (.pth state dict) to the
    native HWIO .npz format (kernels transposed OIHW -> HWIO)."""
    state = torch.load(pth_path, map_location="cpu")
    if hasattr(state, "state_dict"):
        state = state.state_dict()
    params = {}
    for idx in CONV_INDICES:
        w = state[f"features.{idx}.weight"].numpy()  # OIHW
        b = state[f"features.{idx}.bias"].numpy()
        params[f"conv{idx}_kernel"] = np.ascontiguousarray(
            w.transpose(2, 3, 1, 0)
        ).astype(np.float32)
        params[f"conv{idx}_bias"] = b.astype(np.float32)
    _validate(params, pth_path)
    if out_path is not None:
        save_params(params, out_path)
    return params


def _find_torch_hub_checkpoint():
    hub_dirs = [
        Path("~/.cache/torch/hub/checkpoints").expanduser(),
        Path(os.environ.get("TORCH_HOME", "~/.cache/torch")).expanduser()
        / "hub"
        / "checkpoints",
    ]
    for d in hub_dirs:
        if d.is_dir():
            hits = sorted(d.glob("vgg19-*.pth"))
            if hits:
                return hits[0]
    return None


def resolve_params(path=None, allow_random: bool = True, seed: int = 0):
    """Resolve VGG-19 parameters via the search order in the module docstring.

    Returns (params, source_description); params are HWIO numpy arrays.
    """
    if path is not None:
        p = Path(path)
        if p.suffix == ".pth":
            return convert_torchvision(p), f"torchvision checkpoint {p}"
        return load_params(p), str(p)
    env = os.environ.get("STT_VGG19_NPZ")
    if env:
        return load_params(env), f"$STT_VGG19_NPZ={env}"
    if _CACHE_PATH.is_file():
        return load_params(_CACHE_PATH), str(_CACHE_PATH)
    pth = _find_torch_hub_checkpoint()
    if pth is not None:
        params = convert_torchvision(pth, _CACHE_PATH)
        return params, f"torchvision checkpoint {pth} (cached to {_CACHE_PATH})"
    if not allow_random:
        raise FileNotFoundError(
            "No VGG-19 weights found. Provide a .npz/.pth path, set "
            "$STT_VGG19_NPZ, or place vgg19-*.pth in the torch hub cache."
        )
    warnings.warn(
        "No pretrained VGG-19 weights found — using deterministic random "
        "initialization. Stylization will run but output fidelity will not "
        "match the reference. See style_transfer_tpu_torch/models/weights.py "
        "for how to install real weights.",
        stacklevel=2,
    )
    print(
        "WARNING: using randomly initialized VGG-19 weights "
        "(no pretrained checkpoint found).",
        file=sys.stderr,
    )
    return random_params(seed), "random (He init)"


def params_from_jax(params, device="cpu"):
    """HWIO ``conv{i}_kernel`` / ``conv{i}_bias`` arrays (the JAX package's
    and the .npz layout) -> OIHW / bias float32 torch tensors on ``device``.

    Shapes are validated first; the inverse is
    ``{k: v.permute(2, 3, 1, 0)}`` on the kernels.
    """
    params = {k: np.asarray(v) for k, v in params.items()}
    _validate(params, "params")
    out = {}
    for idx in CONV_INDICES:
        k = params[f"conv{idx}_kernel"].transpose(3, 2, 0, 1)  # HWIO -> OIHW
        out[f"conv{idx}_kernel"] = torch.tensor(
            np.ascontiguousarray(k), dtype=torch.float32, device=device)
        out[f"conv{idx}_bias"] = torch.tensor(
            params[f"conv{idx}_bias"], dtype=torch.float32, device=device)
    return out
