"""Color-managed image I/O.

Capability parity with the reference's I/O layer
(crowsonkb/style-transfer-pytorch ``style_transfer/cli.py:23-81``); a copy
of ``style_transfer_tpu/io_color.py``, which needs only numpy and PIL:

* loading honors an embedded ICC profile and converts to sRGB; an optional
  CMYK *soft-proofing* profile round-trips src -> CMYK -> sRGB so the on-
  screen optimization target previews what print output will look like;
* PIL saves embed the sRGB profile (JPEG quality 95 with 4:4:4 subsampling,
  WebP quality 95);
* ``.tif``/``.tiff`` outputs are 16-bit RGB with the sRGB profile in an
  InterColorProfile tag, 72 dpi.

The 16-bit TIFF encoder is implemented here from the TIFF 6.0 spec (the
reference uses the ``tifffile`` dependency; this framework is self-contained).
"""

import io
import struct
import sys
from pathlib import Path

import numpy as np
from PIL import Image, ImageCms

from . import srgb_profile

__all__ = [
    "load_image",
    "save_image",
    "save_pil",
    "save_tiff",
    "encode_tiff_rgb16",
    "prof_to_prof",
    "print_error",
]


def print_error(err):
    print("\033[31m{}:\033[0m {}".format(type(err).__name__, err), file=sys.stderr)


def prof_to_prof(image, src_prof: bytes, dst_prof: bytes, **kwargs):
    """ImageCms profile-to-profile conversion from raw ICC bytes."""
    return ImageCms.profileToProfile(
        image, io.BytesIO(src_prof), io.BytesIO(dst_prof), **kwargs
    )


def load_image(path, proof_prof=None):
    """Open an image, convert to sRGB honoring any embedded profile.

    With ``proof_prof`` (path to a CMYK ICC profile), soft-proof: convert
    source -> CMYK under the proof profile -> back to sRGB.
    """
    src_prof = dst_prof = srgb_profile
    image = Image.open(path)
    if "icc_profile" in image.info:
        src_prof = image.info["icc_profile"]
    else:
        image = image.convert("RGB")
    if proof_prof is None:
        if src_prof == dst_prof:
            return image.convert("RGB")
        return prof_to_prof(image, src_prof, dst_prof, outputMode="RGB")
    proof_bytes = Path(proof_prof).read_bytes()
    cmyk = prof_to_prof(image, src_prof, proof_bytes, outputMode="CMYK")
    return prof_to_prof(cmyk, proof_bytes, dst_prof, outputMode="RGB")


def save_pil(path, image: Image.Image):
    path = Path(path)
    kwargs = {"icc_profile": srgb_profile}
    suffix = path.suffix.lower()
    if suffix in {".jpg", ".jpeg"}:
        kwargs.update(quality=95, subsampling=0)
    elif suffix == ".webp":
        kwargs.update(quality=95)
    image.save(path, **kwargs)


# --------------------------------------------------------------------- TIFF

_TIFF_TYPES = {"SHORT": 3, "LONG": 4, "RATIONAL": 5, "BYTE": 1}


def _ifd_entry(tag, type_name, count, value_or_offset):
    return struct.pack("<HHII", tag, _TIFF_TYPES[type_name], count, value_or_offset)


def encode_tiff_rgb16(arr: np.ndarray, icc_profile: bytes = None, dpi: int = 72) -> bytes:
    """Encode an (H, W, 3) uint16 array as an uncompressed little-endian
    baseline TIFF with optional embedded ICC profile (tag 34675)."""
    if arr.dtype != np.uint16 or arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError("expected (H, W, 3) uint16 array")
    h, w = arr.shape[:2]
    pixel_data = arr.astype("<u2").tobytes()

    # Layout: header(8) | pixel data | out-of-line tag values | IFD
    header_size = 8
    strip_offset = header_size
    after_pixels = strip_offset + len(pixel_data)

    # Out-of-line values
    extra = bytearray()

    def put(data: bytes, align=2):
        nonlocal extra
        off = after_pixels + len(extra)
        extra += data
        if len(extra) % align:
            extra += b"\0" * (align - len(extra) % align)
        return off

    bits_off = put(struct.pack("<HHH", 16, 16, 16))
    xres_off = put(struct.pack("<II", dpi, 1), align=4)
    yres_off = put(struct.pack("<II", dpi, 1), align=4)
    icc_off = put(icc_profile) if icc_profile else None

    entries = [
        _ifd_entry(256, "LONG", 1, w),  # ImageWidth
        _ifd_entry(257, "LONG", 1, h),  # ImageLength
        _ifd_entry(258, "SHORT", 3, bits_off),  # BitsPerSample
        _ifd_entry(259, "SHORT", 1, 1),  # Compression: none
        _ifd_entry(262, "SHORT", 1, 2),  # Photometric: RGB
        _ifd_entry(273, "LONG", 1, strip_offset),  # StripOffsets
        _ifd_entry(277, "SHORT", 1, 3),  # SamplesPerPixel
        _ifd_entry(278, "LONG", 1, h),  # RowsPerStrip
        _ifd_entry(279, "LONG", 1, len(pixel_data)),  # StripByteCounts
        _ifd_entry(282, "RATIONAL", 1, xres_off),  # XResolution
        _ifd_entry(283, "RATIONAL", 1, yres_off),  # YResolution
        _ifd_entry(296, "SHORT", 1, 2),  # ResolutionUnit: inch
    ]
    if icc_profile:
        entries.append(_ifd_entry(34675, "BYTE", len(icc_profile), icc_off))
    entries.sort(key=lambda e: struct.unpack("<H", e[:2])[0])

    ifd_offset = after_pixels + len(extra)
    ifd = (
        struct.pack("<H", len(entries))
        + b"".join(entries)
        + struct.pack("<I", 0)  # next IFD: none
    )
    header = struct.pack("<2sHI", b"II", 42, ifd_offset)
    return header + pixel_data + bytes(extra) + ifd


def save_tiff(path, image: np.ndarray):
    """Save an (H, W, 3) uint16 array as 16-bit TIFF with sRGB ICC, 72 dpi."""
    Path(path).write_bytes(encode_tiff_rgb16(image, icc_profile=srgb_profile))


def save_image(path, image):
    """Dispatch by output type: PIL image -> PIL formats; uint16 ndarray +
    .tif/.tiff -> 16-bit TIFF (ref cli.py:73-81)."""
    path = Path(path)
    print(f"Writing image to {path}.")
    if isinstance(image, Image.Image):
        save_pil(path, image)
    elif isinstance(image, np.ndarray) and path.suffix.lower() in {".tif", ".tiff"}:
        save_tiff(path, image)
    else:
        raise ValueError("Unsupported combination of image type and extension")
