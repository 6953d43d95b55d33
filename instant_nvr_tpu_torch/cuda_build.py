"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` of :data:`KERNELS` has a plain C interface.  At
first use it is compiled with ``nvcc`` for Hopper (``sm_90a``) into a shared
library under ``build/torch_kernels/`` at the root of the checkout, named by
a hash of its source, the headers of ``csrc/`` and its flags, and loaded
with ``ctypes``.  Nothing includes PyTorch's headers, so a build takes
seconds, not minutes.
:func:`build_libraries` compiles several sources at once, one ``nvcc``
each.  A failed build raises: there is no fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable, Tuple

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

# every kernel source -> its extra nvcc flags
KERNELS: Dict[str, Tuple[str, ...]] = {
    # the distances must round like the plain version: no fused multiply-add
    "knn_blend": ("--fmad=false",),
    "knn_topk": ("--fmad=false",),
    "segmented_scatter": (),
    "onehot_scatter": (),
    "sorted_scatter": (),
    # the lerp and the sums must round like the plain chain's: no fused
    # multiply-add
    "hashgrid_encode": ("--fmad=false",),
}

_loaded: Dict[str, Tuple[ctypes.CDLL, Path]] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    cand = os.path.join(CUDA_HOME, "bin", "nvcc") if CUDA_HOME else None
    if cand and os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH "
                           "to build the port's CUDA kernels")
    return found


def library_path(name: str) -> Path:
    # the headers a source may include (knn_select.cuh) change the build too
    h = hashlib.sha256((CSRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + KERNELS[name]).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_libraries(names: Iterable[str] = tuple(KERNELS)) -> None:
    """Compile every ``csrc/<name>.cu`` of ``names`` that has no build yet,
    one ``nvcc`` per source, all started at once.  The compiler's report
    (registers, spills) is kept beside each library as ``<lib>.log``.
    Raises naming every source that failed."""
    procs = []
    for name in names:
        so = library_path(name)
        if so.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = so.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [_nvcc(), *NVCC_FLAGS, *KERNELS[name], "-o", str(tmp),
               str(CSRC_DIR / f"{name}.cu")]
        procs.append((name, so, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, cmd, proc in procs:
        report = proc.communicate()[0]
        if proc.returncode != 0:
            failed.append(f"building {name}.cu failed:\n{' '.join(cmd)}\n{report}")
            continue
        so.with_suffix(".log").write_text(report)
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("\n".join(failed))


def load_library(name: str) -> ctypes.CDLL:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists,
    then load it."""
    if name in _loaded:
        return _loaded[name][0]
    build_libraries([name])
    so = library_path(name)
    lib = ctypes.CDLL(str(so))
    _loaded[name] = (lib, so)
    return lib


def build_log(name: str) -> str:
    """The compiler's report for the loaded build of ``name`` ('' if none)."""
    log = _loaded[name][1].with_suffix(".log")
    return log.read_text() if log.exists() else ""
