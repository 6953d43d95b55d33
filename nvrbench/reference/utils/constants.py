"""Constant tensors made on the host once and kept on the device.

The forward's index tensors (each part's budget, slot and group ids, the
hash grids' corner bits, resolutions and level offsets) depend only on the
static shapes of a call, as they are constants folded into the JAX
package's compiled programs.  :func:`device_constant` builds each one on
the host at its first use per (key, device) and hands back the same device
tensor after, so a chunk or a step copies nothing from the host, and a
CUDA graph capture (which refuses a copy from pageable memory) finds them
ready.  Callers must not write into them.
"""
from __future__ import annotations

from typing import Callable, Dict, Hashable, Tuple

import numpy as np
import torch

_constants: Dict[Tuple[Hashable, torch.device], torch.Tensor] = {}


def device_constant(key: Hashable, device, make: Callable[[], np.ndarray],
                    dtype: torch.dtype | None = None) -> torch.Tensor:
    """``torch.as_tensor(make(), dtype)`` on ``device``, made once per
    (``key``, device).  Raises if the first use of a key falls inside a CUDA
    graph capture: capture cannot copy from the host, so the eager warm-up
    before it must have made the constant."""
    dev = torch.device(device)
    k = (key, dev)
    t = _constants.get(k)
    if t is None:
        if dev.type == "cuda" and torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"constant {key!r} first made under CUDA graph "
                               f"capture; an eager warm-up call must come first")
        t = torch.as_tensor(make(), dtype=dtype).to(dev)
        _constants[k] = t
    return t


def arange(n: int, device, dtype: torch.dtype = torch.int64) -> torch.Tensor:
    """``torch.arange(n)`` as a cached constant."""
    return device_constant(("arange", int(n), dtype), device,
                           lambda: np.arange(int(n)), dtype)
