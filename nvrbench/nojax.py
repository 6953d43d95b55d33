"""The benchmark's guard against JAX: the program measured is the PyTorch
port, and nothing the benchmark loads may bring in JAX, its compiler or the
JAX package the port was made from.

:func:`install` puts an import hook first on ``sys.meta_path`` that refuses
any module whose top-level name (the part before the first dot) is one of
:data:`FORBIDDEN`, compared whole: ``instant_nvr_tpu_torch`` is the port,
``instant_nvr_tpu`` is not.  :func:`loaded` names the forbidden modules that
``sys.modules`` holds, which the run checks again once its window has
closed.
"""
from __future__ import annotations

import importlib.abc
import os
import sys
from typing import List

FORBIDDEN = ("jax", "jaxlib", "flax", "instant_nvr_tpu")


def top_level(name: str) -> str:
    return name.split(".", 1)[0]


class ForbiddenImport(ImportError):
    pass


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, fullname, path=None, target=None):
        if top_level(fullname) in FORBIDDEN:
            raise ForbiddenImport(f"nvrbench: refused to import {fullname!r} "
                                  f"(the benchmark runs the PyTorch port only)")
        return None


def install() -> None:
    """Refuse forbidden imports from now on in this process; also keeps
    ``transformers``-style libraries from loading JAX by themselves."""
    os.environ.setdefault("USE_FLAX", "0")
    if not any(isinstance(f, _Refuse) for f in sys.meta_path):
        sys.meta_path.insert(0, _Refuse())


def loaded() -> List[str]:
    """The modules in ``sys.modules`` whose top-level name is forbidden."""
    return sorted(m for m in list(sys.modules) if top_level(m) in FORBIDDEN)
