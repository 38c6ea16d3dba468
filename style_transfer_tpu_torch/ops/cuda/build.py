"""Build the package's CUDA sources into a shared library at first use.

``nvcc`` compiles every ``csrc/*.cu`` (with the ``csrc/*.cuh`` headers
they include) into one library with a plain C interface for Hopper
(``sm_90a``), loaded with ctypes. The library goes to
``style_transfer_tpu_torch/_build/`` under a name that carries a hash of the
sources and flags, and is written to a temporary file first and renamed into
place, so a concurrent process never loads a half-written library. Nothing
is built when the package is imported, and there is no fallback: without a
CUDA toolkit, :func:`load` raises.
"""

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["load", "library_path", "NVCC_FLAGS"]

_PKG = Path(__file__).resolve().parents[2]
CSRC_DIR = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"

# No --use_fast_math: the Newton-Schulz chain relies on IEEE division and
# square roots. -Xptxas=-v reports registers, shared memory and spills into
# the build log beside the library.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_VP, _I = ctypes.c_void_p, ctypes.c_int
# C symbol -> argtypes; every pointer and the stream are c_void_p.
_SIGNATURES = {
    "stt_ns_norm_slots": [],
    "stt_ns_sqrtm_yz_f32": [_VP] * 7 + [_I, _I, _I, _VP],
    "stt_ns_sqrtm_yz_groups_f32": [_VP, _I, _I, _VP, _VP],
    "stt_ns_groups_capacity": [],
    "stt_ns_max_groups": [],
    "stt_ns_barrier_words": [],
    "stt_ns_sqrtm_f32": [_VP] * 7 + [_I, _I, _I, _VP],
    "stt_lyap_bwd_f32": [_VP] * 9 + [_I, _I, _I, _VP],
    "stt_zoom_ls_num_fields": [],
    "stt_zoom_ls_step_f32": [_VP] * 4 + [_I, _VP],
}


def _sources():
    return sorted(CSRC_DIR.glob("*.cu"))


def library_path(build_dir=None) -> Path:
    """Where the library for the current sources, headers and flags lives."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return Path(build_dir or BUILD_DIR) / f"libstt_kernels_{h.hexdigest()[:16]}.so"


def _find_nvcc() -> str:
    for var in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(var)
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").is_file():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found: style_transfer_tpu_torch builds its CUDA kernels "
        "from csrc/ at first use and needs the CUDA toolkit (set CUDA_HOME "
        "or put nvcc on PATH)"
    )


def _compile(so: Path):
    nvcc = _find_nvcc()
    so.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=so.parent, prefix=so.stem, suffix=".tmp")
    os.close(fd)
    try:
        res = subprocess.run(
            [nvcc, *NVCC_FLAGS, "-o", tmp, *map(str, _sources())],
            capture_output=True, text=True,
        )
        if res.returncode != 0:
            raise RuntimeError(
                f"nvcc failed with exit code {res.returncode}:\n"
                f"{res.stdout}{res.stderr}")
        so.with_suffix(".log").write_text(res.stdout + res.stderr)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


@functools.lru_cache(maxsize=None)
def load(build_dir=None) -> ctypes.CDLL:
    """Build (once per source hash) and load the kernel library."""
    so = library_path(build_dir)
    if not so.is_file():
        _compile(so)
    lib = ctypes.CDLL(str(so))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib
