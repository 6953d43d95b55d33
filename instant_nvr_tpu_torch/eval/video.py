"""MP4 files without ffmpeg: MPEG-4 Part 2 video (mp4v) in ISO BMFF.

The JAX package writes its bullet-time and novel-view videos with ffmpeg
and falls back to ``cv2.VideoWriter(..., fourcc "mp4v", fps)``; the card's
machine has neither.  This module is the port's fallback: the host encoder
``instant_nvr_tpu_torch/csrc/mp4v.cpp`` (Simple Profile, every frame an
I-VOP at a fixed quantiser; built with g++ at first use by
``utils/native.py:build_host_library``) and an ISO BMFF writer around it,
laid out as cv2's own mp4v files are: ``ftyp`` (isom), ``mdat`` (one
sample a frame) and ``moov`` (``mvhd``, one video ``trak`` whose ``stsd``
holds an ``mp4v`` entry with the stream's headers in its ``esds``; every
sample a sync sample, one chunk each).  :func:`read_mp4` parses such a
file back (brand, codec, size, rate, sample sizes), with its bounds
checked, for checks on a machine without a decoder.

    write_mp4("out.mp4", frames, fps=24)   # frames: (H, W, 3) uint8 RGB
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
from pathlib import Path
from typing import Dict, Iterable, List

import numpy as np

from ..utils import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "mp4v.cpp"
# vop_quant of every frame: H.263 steps of 2 x 4 in the DCT domain
QUANT = 4
MIN_SIDE, MAX_SIDE = 16, 4096
_MOVIE_TIMESCALE = 1000
_MATRIX = struct.pack(">9I", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)
_CONTAINERS = {b"moov", b"trak", b"mdia", b"minf", b"stbl", b"dinf"}

_lock = threading.Lock()
_lib = None


def library_path() -> Path:
    return native.host_library_path(SOURCE)


def load() -> ctypes.CDLL:
    """The encoder library, built and bound on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build_host_library(SOURCE)))
            i64, c_int = ctypes.c_int64, ctypes.c_int
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.mp4v_frame_capacity.restype = i64
            lib.mp4v_frame_capacity.argtypes = [c_int, c_int]
            lib.mp4v_headers.restype = i64
            lib.mp4v_headers.argtypes = [c_int, c_int, c_int, u8p, i64]
            lib.mp4v_encode_frame.restype = i64
            lib.mp4v_encode_frame.argtypes = [u8p, c_int, c_int, c_int, i64, c_int, u8p, i64]
            _lib = lib
        return _lib


def _check_frame(frame, shape=None) -> np.ndarray:
    f = np.asarray(frame)
    if f.dtype != np.uint8 or f.ndim != 3 or f.shape[2] != 3:
        raise ValueError(f"a frame must be (H, W, 3) uint8 RGB, got {f.dtype} {f.shape}")
    H, W = f.shape[:2]
    if not (MIN_SIDE <= H <= MAX_SIDE and MIN_SIDE <= W <= MAX_SIDE):
        raise ValueError(f"frame of {W}x{H}: each side must be {MIN_SIDE}..{MAX_SIDE}")
    if shape is not None and f.shape != shape:
        raise ValueError(f"frames of mixed sizes: {f.shape[1]}x{f.shape[0]} after "
                         f"{shape[1]}x{shape[0]}")
    return np.ascontiguousarray(f)


def _check_rate(fps: int, quant: int) -> None:
    if int(fps) != fps or not 1 <= fps <= 65535:
        raise ValueError(f"fps must be an integer 1..65535, got {fps}")
    if int(quant) != quant or not 1 <= quant <= 31:
        raise ValueError(f"quant must be an integer 1..31, got {quant}")


def stream_headers(width: int, height: int, fps: int) -> bytes:
    """The visual object sequence, visual object and video object layer
    headers (the esds box's decoder-specific information)."""
    out = np.empty(64, np.uint8)
    n = load().mp4v_headers(width, height, fps, out, out.size)
    if n < 0:
        raise ValueError(f"mp4v headers of {width}x{height} at {fps} fps: error {n}")
    return out[:n].tobytes()


def encode_frame(frame: np.ndarray, fps: int, index: int, quant: int = QUANT,
                 buf: np.ndarray | None = None) -> bytes:
    """One (H, W, 3) uint8 RGB frame as an I-VOP shown at ``index / fps`` s."""
    f = _check_frame(frame)
    _check_rate(fps, quant)
    H, W = f.shape[:2]
    lib = load()
    cap = lib.mp4v_frame_capacity(W, H)
    if buf is None or buf.size < cap:
        buf = np.empty(cap, np.uint8)
    n = lib.mp4v_encode_frame(f, W, H, int(fps), int(index), int(quant), buf, buf.size)
    if n < 0:
        raise RuntimeError(f"mp4v encode of frame {index} failed: error {n}")
    return buf[:n].tobytes()


def _box(kind: bytes, *payload: bytes) -> bytes:
    body = b"".join(payload)
    return struct.pack(">I4s", 8 + len(body), kind) + body


def _full_box(kind: bytes, version: int, flags: int, *payload: bytes) -> bytes:
    return _box(kind, struct.pack(">I", (version << 24) | flags), *payload)


def _descriptor(tag: int, body: bytes) -> bytes:
    n = len(body)
    size = bytes([0x80 | (n >> 21) & 0x7F, 0x80 | (n >> 14) & 0x7F,
                  0x80 | (n >> 7) & 0x7F, n & 0x7F])
    return bytes([tag]) + size + body


def _moov(width: int, height: int, fps: int, headers: bytes, sizes: List[int],
          offsets: List[int]) -> bytes:
    n = len(sizes)
    duration = round(n * _MOVIE_TIMESCALE / fps)
    mvhd = _full_box(b"mvhd", 0, 0, struct.pack(">IIII", 0, 0, _MOVIE_TIMESCALE, duration),
                     struct.pack(">IH", 0x10000, 0x100), bytes(10), _MATRIX, bytes(24),
                     struct.pack(">I", 2))
    tkhd = _full_box(b"tkhd", 0, 3, struct.pack(">IIIII", 0, 0, 1, 0, duration), bytes(8),
                     struct.pack(">hhhH", 0, 0, 0, 0), _MATRIX,
                     struct.pack(">II", width << 16, height << 16))
    mdhd = _full_box(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, fps, n, 0x55C4, 0))
    hdlr = _full_box(b"hdlr", 0, 0, struct.pack(">I4s", 0, b"vide"), bytes(12),
                     b"VideoHandler\0")
    vmhd = _full_box(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    dinf = _box(b"dinf", _full_box(b"dref", 0, 0, struct.pack(">I", 1),
                                   _full_box(b"url ", 0, 1)))
    seconds = n / fps
    total = sum(sizes)
    config = _descriptor(4, bytes([0x20, 0x11]) + max(sizes).to_bytes(3, "big")
                         + struct.pack(">II", min(max(sizes) * 8 * fps, 2 ** 32 - 1),
                                       min(round(total * 8 / seconds), 2 ** 32 - 1))
                         + _descriptor(5, headers))
    esds = _full_box(b"esds", 0, 0, _descriptor(3, struct.pack(">HB", 1, 0) + config
                                                + _descriptor(6, b"\x02")))
    mp4v = _box(b"mp4v", bytes(6), struct.pack(">H", 1), bytes(16),
                struct.pack(">HHII", width, height, 0x480000, 0x480000), bytes(4),
                struct.pack(">H", 1), bytes(32), struct.pack(">Hh", 0x18, -1), esds)
    stbl = _box(b"stbl",
                _full_box(b"stsd", 0, 0, struct.pack(">I", 1), mp4v),
                _full_box(b"stts", 0, 0, struct.pack(">III", 1, n, 1)),
                _full_box(b"stss", 0, 0, struct.pack(f">I{n}I", n, *range(1, n + 1))),
                _full_box(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, 1, 1)),
                _full_box(b"stsz", 0, 0, struct.pack(f">II{n}I", 0, n, *sizes)),
                _full_box(b"stco", 0, 0, struct.pack(f">I{n}I", n, *offsets)))
    minf = _box(b"minf", vmhd, dinf, stbl)
    trak = _box(b"trak", tkhd, _box(b"mdia", mdhd, hdlr, minf))
    return _box(b"moov", mvhd, trak)


def write_mp4(path: str, frames: Iterable[np.ndarray], fps: int = 24,
              quant: int = QUANT) -> Dict[str, int]:
    """Encode ``frames`` ((H, W, 3) uint8 RGB, one size, each side 16..4096)
    into ``path`` at ``fps``, one frame in memory at a time.  Raises
    ``ValueError`` for no frames, mixed sizes or a size out of range, and
    then leaves no file.  Returns {"frames", "bytes", "width", "height"}."""
    _check_rate(fps, quant)
    ftyp = _box(b"ftyp", b"isom", struct.pack(">I", 0x200), b"isom", b"iso2", b"mp41")
    sizes, offsets = [], []
    shape = headers = buf = None
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            f.write(ftyp)
            f.write(struct.pack(">I4s", 0, b"mdat"))        # size patched below
            pos = len(ftyp) + 8
            for i, frame in enumerate(frames):
                frame = _check_frame(frame, shape)
                if shape is None:
                    shape = frame.shape
                    headers = stream_headers(shape[1], shape[0], fps)
                    buf = np.empty(load().mp4v_frame_capacity(shape[1], shape[0]),
                                   np.uint8)
                sample = encode_frame(frame, fps, i, quant, buf)
                f.write(sample)
                offsets.append(pos)
                sizes.append(len(sample))
                pos += len(sample)
            if shape is None:
                raise ValueError(f"{path}: no frames to write")
            if pos >= 2 ** 32:
                raise ValueError(f"{path}: {pos} bytes of samples exceed 32-bit offsets")
            f.write(_moov(shape[1], shape[0], fps, headers, sizes, offsets))
            f.seek(len(ftyp))
            f.write(struct.pack(">I", pos - len(ftyp)))
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return {"frames": len(sizes), "bytes": os.path.getsize(path), "width": shape[1],
            "height": shape[0]}


def _boxes(data: bytes, start: int, end: int, where: str):
    """(type, payload start, payload end) of each box in data[start:end]."""
    while start < end:
        if end - start < 8:
            raise ValueError(f"{where}: {end - start} stray bytes")
        size, kind = struct.unpack_from(">I4s", data, start)
        if size < 8 or start + size > end:
            raise ValueError(f"{where}: box {kind!r} of {size} bytes overruns its parent")
        yield kind, start + 8, start + size
        start += size


def read_mp4(path: str) -> Dict[str, object]:
    """The layout of an mp4 file with one video track: ``brand``,
    ``compatible``, ``codec`` (the sample entry's type), ``object_type``
    (the esds decoder's, 0x20 for MPEG-4 Visual), ``width``, ``height``,
    ``timescale``, ``duration``, ``fps``, ``sample_sizes``,
    ``sample_offsets``, ``sync_samples`` and ``headers`` (the decoder's
    configuration bytes).  Every sample must lie inside ``mdat``; raises
    ``ValueError`` naming the file for anything else."""
    data = Path(path).read_bytes()
    found: Dict[str, object] = {}
    mdat = None

    def walk(start, end, depth):
        nonlocal mdat
        for kind, a, b in _boxes(data, start, end, path):
            if kind == b"ftyp":
                found["brand"] = data[a:a + 4].decode("latin-1")
                found["compatible"] = [data[i:i + 4].decode("latin-1")
                                       for i in range(a + 8, b - 3, 4)]
            elif kind == b"mdat" and depth == 0:
                mdat = (a, b)
            elif kind in _CONTAINERS:
                walk(a, b, depth + 1)
            elif kind == b"mdhd":
                found["timescale"], found["duration"] = struct.unpack_from(">II", data, a + 12)
            elif kind == b"stsd":
                entries = list(_boxes(data, a + 8, b, path))
                if len(entries) != 1:
                    raise ValueError(f"{path}: {len(entries)} sample entries")
                kind, ea, eb = entries[0]
                found["codec"] = kind.decode("latin-1")
                found["width"], found["height"] = struct.unpack_from(">HH", data, ea + 24)
                for sub, sa, sb in _boxes(data, ea + 78, eb, path):
                    if sub == b"esds":
                        _read_esds(data[sa + 4:sb], found, path)
            elif kind == b"stsz":
                size, n = struct.unpack_from(">II", data, a + 4)
                if size or b - a < 12 + 4 * n:
                    raise ValueError(f"{path}: stsz of {n} samples does not fit")
                found["sample_sizes"] = list(struct.unpack_from(f">{n}I", data, a + 12))
            elif kind == b"stco":
                (n,) = struct.unpack_from(">I", data, a + 4)
                if b - a < 8 + 4 * n:
                    raise ValueError(f"{path}: stco of {n} chunks does not fit")
                found["chunk_offsets"] = list(struct.unpack_from(f">{n}I", data, a + 8))
            elif kind == b"stsc":
                (n,) = struct.unpack_from(">I", data, a + 4)
                if b - a < 8 + 12 * n:
                    raise ValueError(f"{path}: stsc of {n} entries does not fit")
                found["chunk_runs"] = [struct.unpack_from(">II", data, a + 8 + 12 * i)
                                       for i in range(n)]
            elif kind == b"stss":
                (n,) = struct.unpack_from(">I", data, a + 4)
                if b - a < 8 + 4 * n:
                    raise ValueError(f"{path}: stss of {n} samples does not fit")
                found["sync_samples"] = list(struct.unpack_from(f">{n}I", data, a + 8))

    walk(0, len(data), 0)
    missing = ({"brand", "codec", "timescale", "sample_sizes", "chunk_offsets",
                "chunk_runs"} - set(found))
    if missing or mdat is None:
        raise ValueError(f"{path}: no {sorted(missing) or ['mdat']}")
    sizes = found["sample_sizes"]
    offsets = _sample_offsets(found["chunk_offsets"], found["chunk_runs"], sizes, path)
    if any(o < mdat[0] or o + s > mdat[1] for o, s in zip(offsets, sizes)):
        raise ValueError(f"{path}: samples outside mdat")
    found["sample_offsets"] = offsets
    found["fps"] = found["timescale"] * len(sizes) / max(found["duration"], 1)
    return found


def _sample_offsets(chunks: List[int], runs, sizes: List[int], path: str) -> List[int]:
    """Each sample's file offset from ``stco``, the ``stsc`` runs (first
    chunk, samples per chunk; each run lasts until the next one's first
    chunk) and the sample sizes."""
    if not runs or runs[0][0] != 1:
        raise ValueError(f"{path}: stsc does not start at chunk 1")
    out = []
    for c, offset in enumerate(chunks, start=1):
        for _ in range([per for first, per in runs if first <= c][-1]):
            if len(out) == len(sizes):
                raise ValueError(f"{path}: chunks hold more samples than stsz's "
                                 f"{len(sizes)}")
            out.append(offset)
            offset += sizes[len(out) - 1]
    if len(out) != len(sizes):
        raise ValueError(f"{path}: chunks hold {len(out)} samples, stsz {len(sizes)}")
    return out


def _read_esds(body: bytes, found: Dict[str, object], path: str) -> None:
    """The ES descriptor's object type and decoder-specific bytes."""
    def descriptors(b: bytes):
        i = 0
        while i < len(b):
            tag, n, i = b[i], 0, i + 1
            for _ in range(4):
                if i >= len(b):
                    raise ValueError(f"{path}: esds descriptor cut short")
                n, i = (n << 7) | (b[i] & 0x7F), i + 1
                if not b[i - 1] & 0x80:
                    break
            if i + n > len(b):
                raise ValueError(f"{path}: esds descriptor overruns")
            yield tag, b[i:i + n]
            i += n

    for tag, es in descriptors(body):
        if tag == 3:
            for sub, dc in descriptors(es[3:]):
                if sub == 4:
                    found["object_type"] = dc[0]
                    for info, dsi in descriptors(dc[13:]):
                        if info == 5:
                            found["headers"] = dsi
