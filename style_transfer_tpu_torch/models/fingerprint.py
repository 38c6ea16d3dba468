"""Activation fingerprints for pretrained-weight port verification.

Port of ``style_transfer_tpu/models/fingerprint.py``, same file format
(``stt-vgg19-fingerprint-v1``), probe image, taps and tolerances, so a
fixture made by either package (``tools/make_weight_fingerprint.py``)
verifies the other's weights and trunk. A parameter set is fingerprinted
two ways:

1. per-key SHA-256 checksums of the raw f32 bytes of the JAX-layout (HWIO)
   arrays, as the ``.npz`` store holds them;
2. per-tap activation statistics (mean / std / L2 norm + pinned exact
   values) of the port's FP32 trunk on a fixed deterministic 32x32 input,
   run on an explicit device (``cuda:0`` by default). The activations are
   taken in the fixture's NHWC layout: ``shape`` and ``sample_idx`` (an
   index into the flattened activation) are NHWC.
"""

import hashlib
import json

import numpy as np
import torch

__all__ = [
    "DEFAULT_TAPS",
    "fingerprint_input",
    "weight_checksums",
    "activation_stats",
    "make_fingerprint",
    "check_fingerprint",
    "save_fingerprint",
    "load_fingerprint",
]

# The engine's tap set: style layers [1, 6, 11, 20, 29] + content [22].
DEFAULT_TAPS = (1, 6, 11, 20, 22, 29)

# Tolerances for the activation comparison (the JAX module's): FP32 trunks
# reproduce to ~1e-6 relative; a transpose/offset slip moves deep-tap
# statistics by 1e-1..1e1 relative.
_STAT_RTOL = 1e-3
_SAMPLE_RTOL = 5e-3
_SAMPLE_ATOL = 1e-4
_N_SAMPLES = 7


def fingerprint_input():
    """Fixed deterministic (1, 32, 32, 3) f32 probe image in [0, 1]."""
    rng = np.random.RandomState(12345)
    return rng.uniform(size=(1, 32, 32, 3)).astype(np.float32)


def weight_checksums(params):
    """{key: sha256 hex} of each parameter's raw f32 little-endian bytes;
    ``params`` in the JAX layout (HWIO kernels), as the .npz store."""
    out = {}
    for k in sorted(params):
        arr = np.ascontiguousarray(np.asarray(params[k], np.float32))
        if arr.dtype.byteorder == ">":  # big-endian host: normalize bytes
            arr = arr.astype("<f4")
        out[k] = hashlib.sha256(arr.tobytes()).hexdigest()
    return out


def activation_stats(params, taps=DEFAULT_TAPS, device="cuda:0"):
    """Per-tap activation statistics on the fixed probe input, from the
    plain (max-pool, FP32) trunk on ``device``; ``params`` in the JAX
    layout. Each activation is taken NHWC before it is flattened."""
    from .vgg import extract_features, fp32_math
    from .weights import params_from_jax

    device = torch.device(device)
    taps = tuple(sorted(set(taps)))
    x = torch.from_numpy(fingerprint_input()).permute(0, 3, 1, 2).contiguous()
    with fp32_math(device), torch.no_grad():
        feats = extract_features(params_from_jax(params, device), x.to(device), taps)
        feats = {t: feats[t].permute(0, 2, 3, 1).cpu().numpy() for t in taps}
    stats = {}
    for tap in taps:
        a = np.asarray(feats[tap], np.float64).ravel()
        idx = np.linspace(0, a.size - 1, _N_SAMPLES).astype(int)
        stats[str(tap)] = {
            "shape": list(feats[tap].shape),
            "mean": float(a.mean()),
            "std": float(a.std()),
            "l2": float(np.linalg.norm(a)),
            "sample_idx": idx.tolist(),
            "samples": [float(a[i]) for i in idx],
        }
    return stats


def make_fingerprint(params, source="unknown", taps=DEFAULT_TAPS, device="cuda:0"):
    """Full fingerprint dict (JSON-serializable)."""
    return {
        "format": "stt-vgg19-fingerprint-v1",
        "source": str(source),
        "taps": sorted(set(taps)),
        "checksums": weight_checksums(params),
        "activations": activation_stats(params, taps, device),
    }


def check_fingerprint(fingerprint, params, check_checksums=True, device="cuda:0"):
    """Verify ``params`` against a fingerprint. Returns a list of mismatch
    descriptions; empty means the port is verified. Checksum mismatches are
    reported but activation statistics are always checked too (weights from
    a different serialization of the same numbers pass on statistics)."""
    problems = []
    if check_checksums:
        want = fingerprint.get("checksums", {})
        got = weight_checksums(params)
        if set(want) != set(got):
            problems.append(
                f"parameter key sets differ: fixture has {len(want)}, "
                f"resolved weights have {len(got)}"
            )
        for k in sorted(set(want) & set(got)):
            if want[k] != got[k]:
                problems.append(f"sha256 mismatch for {k}")
    got_stats = activation_stats(params, tuple(fingerprint["taps"]), device)
    for tap, want in fingerprint["activations"].items():
        got = got_stats[tap]
        if want.get("shape") and list(want["shape"]) != list(got["shape"]):
            problems.append(
                f"tap {tap}: activation shape {got['shape']} != fixture "
                f"{want['shape']} (layer indexing is off)"
            )
            continue
        for stat in ("mean", "std", "l2"):
            w, g = want[stat], got[stat]
            if abs(g - w) > _STAT_RTOL * max(abs(w), 1e-12):
                problems.append(
                    f"tap {tap}: {stat} {g:.6g} != fixture {w:.6g} "
                    f"(rel err {abs(g - w) / max(abs(w), 1e-12):.2e})"
                )
        for i, (w, g) in enumerate(zip(want["samples"], got["samples"])):
            if abs(g - w) > _SAMPLE_RTOL * abs(w) + _SAMPLE_ATOL:
                problems.append(
                    f"tap {tap}: sample {i} (flat index "
                    f"{want['sample_idx'][i]}) {g:.6g} != fixture {w:.6g}"
                )
    return problems


def save_fingerprint(fingerprint, path):
    with open(path, "w") as f:
        json.dump(fingerprint, f, indent=1, sort_keys=True)
        f.write("\n")


def load_fingerprint(path):
    with open(path) as f:
        fp = json.load(f)
    if fp.get("format") != "stt-vgg19-fingerprint-v1":
        raise ValueError(f"{path}: not a stt-vgg19-fingerprint-v1 file")
    return fp
