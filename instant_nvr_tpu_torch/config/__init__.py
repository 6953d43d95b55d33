"""Config tree for the PyTorch port: a copy of ``instant_nvr_tpu.config``.

Copied rather than imported because importing anything under
``instant_nvr_tpu`` imports jax, which the port never does.  It reads the
same ``configs/inb/*.yaml`` files and must resolve them identically
(tests/test_torch_config.py).
"""
from .config import Config, dump_cfg, load_yaml_config, finalize
from .defaults import default_config

__all__ = ["Config", "dump_cfg", "load_yaml_config", "finalize",
           "default_config", "make_cfg"]


def make_cfg(cfg_file: str, opts=None):
    """Load defaults → parent chain → cfg_file → CLI opts, then finalize."""
    cfg = load_yaml_config(cfg_file, defaults=default_config(), opts=list(opts or []))
    return finalize(cfg)
