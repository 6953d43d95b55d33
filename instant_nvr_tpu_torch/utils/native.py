"""ctypes bindings of the native host library ``csrc/nvrhost.cpp`` (port of
``instant_nvr_tpu/utils/native.py``).

``ray_dirs``, ``near_far`` and ``sample_pixels`` run once per training item
on the producer threads, without the interpreter lock.  The library is
compiled with ``g++`` and the flags of ``csrc/build.sh`` at first use, into
``build/torch_kernels/`` at the root of the checkout, named by a hash of
the source, the flags and the host (``-march=native`` makes a build fit
only the CPU that compiled it; ``csrc/build.sh`` writes the tracked
``csrc/libnvrhost.so`` in place, so it is never run from here).  A failed
build raises: the port has no numpy fallback on its path, because the
weighted pixel draw of the numpy version takes other random numbers than
the library's mt19937, and the JAX package's sampler uses the library
wherever it builds.  The numpy versions stay in ``ops/ray.py`` and
``datasets/sampling.py`` as the plain versions the tests hold it against.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import subprocess
import threading
from pathlib import Path
from typing import Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[2]
SOURCE = ROOT / "csrc" / "nvrhost.cpp"
BUILD_DIR = ROOT / "build" / "torch_kernels"
FLAGS = ("-O3", "-march=native", "-fPIC", "-shared", "-std=c++17")

_lock = threading.Lock()
_lib = None


def host_library_path(source: Path) -> Path:
    """``build/torch_kernels/lib<stem>_<hash>.so`` of a host C++ source."""
    h = hashlib.sha256(Path(source).read_bytes())
    h.update(" ".join(FLAGS + (platform.node(), platform.machine())).encode())
    return BUILD_DIR / f"lib{Path(source).stem}_{h.hexdigest()[:16]}.so"


def build_host_library(source: Path) -> Path:
    """Compile a host C++ source with g++ unless this exact build exists;
    raises with the compiler's output if it fails."""
    so = host_library_path(source)
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".tmp{os.getpid()}.so")
    cmd = ["g++", *FLAGS, "-o", str(tmp), str(source)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"building {Path(source).name} failed:\n{' '.join(cmd)}\n"
                           f"{res.stdout}{res.stderr}")
    os.replace(tmp, so)
    return so


def library_path() -> Path:
    return host_library_path(SOURCE)


def build() -> Path:
    """Compile ``csrc/nvrhost.cpp`` unless this exact build exists."""
    return build_host_library(SOURCE)


def load() -> ctypes.CDLL:
    """The library, built and bound on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            i64 = ctypes.c_int64
            f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
            f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
            i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
            u8p = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
            lib.ray_dirs.restype = None
            lib.ray_dirs.argtypes = [f64p, f64p, f64p, i64p, i64, f32p, f32p]
            lib.near_far.restype = i64
            lib.near_far.argtypes = [f32p, f32p, f32p, i64, f32p, f32p, u8p,
                                     ctypes.c_int]
            lib.sample_pixels.restype = i64
            lib.sample_pixels.argtypes = [u8p, u8p, i64, i64, i64, i64, i64,
                                          ctypes.c_uint64, i64p]
            _lib = lib
        return _lib


def ray_dirs(K: np.ndarray, R: np.ndarray, T: np.ndarray,
             coords: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Rays for (row, col) pixel coords -> (origins (n, 3), unit dirs (n, 3))."""
    n = len(coords)
    out_o = np.empty((n, 3), np.float32)
    out_d = np.empty((n, 3), np.float32)
    load().ray_dirs(np.ascontiguousarray(K, np.float64),
                    np.ascontiguousarray(R, np.float64),
                    np.ascontiguousarray(T, np.float64).reshape(-1),
                    np.ascontiguousarray(coords, np.int64), n, out_o, out_d)
    return out_o, out_d


def near_far(bounds: np.ndarray, ray_o: np.ndarray, ray_d: np.ndarray):
    """(near, far, hit mask): near/far of the rays that hit the box only,
    as ``ops.ray.get_near_far_np`` returns them."""
    n = len(ray_o)
    near = np.empty(n, np.float32)
    far = np.empty(n, np.float32)
    hit = np.empty(n, np.uint8)
    n_hit = load().near_far(np.ascontiguousarray(bounds, np.float32),
                            np.ascontiguousarray(ray_o, np.float32),
                            np.ascontiguousarray(ray_d, np.float32),
                            n, near, far, hit, 1)
    return near[:n_hit].copy(), far[:n_hit].copy(), hit.astype(bool)


def sample_pixels(msk: np.ndarray, bound_mask: np.ndarray, n_body: int,
                  n_face: int, n_rand: int, seed: int) -> np.ndarray:
    """Weighted (row, col) pixel draw: ``n_body`` from ``msk == 1``,
    ``n_face`` from ``msk == 13``, the rest (and the share of an empty
    class) from ``bound_mask == 1``, by mt19937-64 from ``seed``."""
    H, W = msk.shape
    out = np.empty((n_body + n_face + n_rand, 2), np.int64)
    n = load().sample_pixels(np.ascontiguousarray(msk, np.uint8),
                             np.ascontiguousarray(bound_mask, np.uint8),
                             H, W, n_body, n_face, n_rand, seed, out)
    return out[:n]
