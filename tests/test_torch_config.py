"""The port's config loader resolves every inb YAML exactly like JAX's."""
import glob
import os

import pytest

from instant_nvr_tpu.config import make_cfg as jax_make_cfg
from instant_nvr_tpu_torch.config import make_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "configs", "inb", "*.yaml")))


def plain(x):
    """Nested dicts/lists of scalars (Configs sit inside lists, and the two
    packages' Config classes never compare equal to each other)."""
    if hasattr(x, "to_dict"):
        x = x.to_dict()
    if isinstance(x, dict):
        return {k: plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [plain(v) for v in x]
    return x


def test_all_configs_found():
    assert len(YAMLS) == 16


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_make_cfg_matches_jax(path, monkeypatch):
    # parent_cfg paths are relative to the repo root
    monkeypatch.chdir(ROOT)
    assert plain(make_cfg(path)) == plain(jax_make_cfg(path))


def test_overrides_match_jax(monkeypatch):
    monkeypatch.chdir(ROOT)
    opts = ["train.lr", "1e-3", "N_samples", "32", "eval_ratio", "0.25"]
    path = os.path.join(ROOT, "configs", "inb", "inb_377.yaml")
    got = make_cfg(path, opts)
    assert plain(got) == plain(jax_make_cfg(path, opts))
    assert got.N_samples == 32 and got.train.lr == 1e-3
