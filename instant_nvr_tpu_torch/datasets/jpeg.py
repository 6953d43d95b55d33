"""ctypes bindings of the host image decoder ``csrc/imgdecode.cpp``.

The JAX package reads its images with ``imageio.v2.imread`` (PIL on
libjpeg-turbo); the card's machine has no cv2, imageio or PIL, so the port
decodes baseline JPEG itself, with libjpeg-turbo's integer IDCT, fancy
upsampling and colour tables, and gives the same pixels
(``tests/test_torch_jpeg.py``).  EXIF orientation is not applied, as
``imageio.v2.imread`` does not apply it.  Every other kind of JPEG
(progressive, arithmetic, lossless, hierarchical, 12-bit, CMYK, RGB-coded
or Adobe-transformed, sampling other than 4:4:4, 4:2:2, 4:2:0 and 4:4:0,
truncated or corrupt) raises ``ValueError`` naming the file; there is no
fallback reader.  The same library undoes PNG row filters for
``image_ops.read_png``.

The library is built with g++ at first use into ``build/torch_kernels/``
(``utils/native.py:build_host_library``, keyed by the source's hash); a failed
build raises.  Decoding runs without the interpreter lock, so the
prefetcher's threads decode in parallel.
"""
from __future__ import annotations

import ctypes
import threading
from pathlib import Path

import numpy as np

from ..utils import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "imgdecode.cpp"
JPEG_MAGIC = b"\xff\xd8\xff"
_ERRLEN = 512

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    return native.host_library_path(SOURCE)


def load() -> ctypes.CDLL:
    """The library, built and bound on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build_host_library(SOURCE)))
            i64 = ctypes.c_int64
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            lib.jpeg_header.restype = ctypes.c_int
            lib.jpeg_header.argtypes = [ctypes.c_char_p, i64, i64p,
                                        ctypes.c_char_p, i64]
            lib.jpeg_decode.restype = ctypes.c_int
            lib.jpeg_decode.argtypes = [ctypes.c_char_p, i64, u8p,
                                        ctypes.c_char_p, i64]
            lib.png_unfilter.restype = i64
            lib.png_unfilter.argtypes = [u8p, i64, i64, i64, u8p]
            _lib = lib
        return _lib


def decode_jpeg(data: bytes, name: str = "<bytes>") -> np.ndarray:
    """A baseline JPEG's pixels: uint8 (H, W, 3) RGB or (H, W) gray, as
    ``imageio.v2.imread`` returns them.  Raises ``ValueError`` naming
    ``name`` for anything it does not decode."""
    lib = load()
    err = ctypes.create_string_buffer(_ERRLEN)
    dims = np.zeros(3, np.int64)
    if lib.jpeg_header(data, len(data), dims, err, _ERRLEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    H, W, C = (int(x) for x in dims)
    out = np.empty((H, W, C) if C == 3 else (H, W), np.uint8)
    if lib.jpeg_decode(data, len(data), out, err, _ERRLEN) != 0:
        raise ValueError(f"{name}: {err.value.decode()}")
    return out


def png_unfilter(rows: np.ndarray, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: ``rows`` (H, 1 + W*bpp) uint8, each row led
    by its filter byte -> (H, W*bpp) image bytes.  Raises ``ValueError`` on
    a filter byte above 4."""
    rows = np.ascontiguousarray(rows, np.uint8)
    H, stride = rows.shape
    out = np.empty((H, stride - 1), np.uint8)
    bad = load().png_unfilter(rows, H, stride - 1, bpp, out)
    if bad:
        raise ValueError(f"PNG row filter {int(rows[bad - 1, 0])} unknown")
    return out
