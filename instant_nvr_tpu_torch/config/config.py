"""Immutable config tree with YAML loading, parent inheritance and CLI overrides.

Replaces the reference's ambient mutable yacs singleton (reference:
``lib/config/config.py`` + vendored ``lib/config/yacs.py``) with an explicit,
frozen config object that is passed around.  The YAML surface is kept
compatible: one-level ``parent_cfg`` inheritance, unknown keys accepted on
merge, dotted-list CLI overrides (``key.subkey value``).

Unlike the reference, nothing here mutates at runtime: training stages
(reference ``train_net.py:64-75``) are expressed as per-epoch *derived views*
via :meth:`Config.replace` (see ``instant_nvr_tpu/train/stages.py``).
"""
from __future__ import annotations

import ast
import copy
import os
from typing import Any, Dict, Iterator, List, Optional

import re

import yaml


class _YamlLoader(yaml.SafeLoader):
    """SafeLoader with the YAML-1.2 float resolver (parses ``5e-4`` etc.)."""


_YamlLoader.add_implicit_resolver(
    "tag:yaml.org,2002:float",
    re.compile(r"""^(?:
        [-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
       |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
       |\.[0-9_]+(?:[eE][-+][0-9]+)?
       |[-+]?\.(?:inf|Inf|INF)
       |\.(?:nan|NaN|NAN))$""", re.X),
    list("-+0123456789."),
)


class Config:
    """A frozen, attribute-accessible nested mapping.

    Values are plain Python scalars, lists, or nested :class:`Config` nodes.
    Mutation after construction raises; derive modified copies with
    :meth:`replace` / :meth:`merged`.
    """

    __slots__ = ("_data", "_frozen")

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        object.__setattr__(self, "_frozen", False)
        object.__setattr__(self, "_data", {})
        if data:
            for k, v in data.items():
                self._data[k] = _convert(v)
        object.__setattr__(self, "_frozen", True)

    # -- mapping protocol -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        # avoid recursion when copy/pickle probes dunders on a bare instance
        if name.startswith("_"):
            raise AttributeError(name)
        try:
            data = object.__getattribute__(self, "_data")
        except AttributeError:
            raise AttributeError(name) from None
        try:
            return data[name]
        except KeyError:
            raise AttributeError(f"Config has no key {name!r}") from None

    def __reduce__(self):
        return (Config, (self.to_dict(),))

    def __deepcopy__(self, memo):
        return Config(self.to_dict())

    def __getitem__(self, name: str) -> Any:
        return self._data[name]

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def keys(self):
        return self._data.keys()

    def items(self):
        return self._data.items()

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def __setattr__(self, name: str, value: Any) -> None:
        raise AttributeError("Config is immutable; use .replace(**kw) or .merged(d)")

    def __setitem__(self, name: str, value: Any) -> None:
        raise TypeError("Config is immutable; use .replace(**kw) or .merged(d)")

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def __eq__(self, other: Any) -> bool:
        if isinstance(other, Config):
            return self.to_dict() == other.to_dict()
        return NotImplemented

    def __hash__(self):
        # hashable so configs can be jit static args if small; hash on sorted repr
        return hash(repr(sorted(self.to_dict().items(), key=lambda kv: kv[0])))

    # -- derivation -------------------------------------------------------
    def to_dict(self) -> Dict[str, Any]:
        out = {}
        for k, v in self._data.items():
            out[k] = v.to_dict() if isinstance(v, Config) else copy.deepcopy(v)
        return out

    def replace(self, **kwargs: Any) -> "Config":
        """Return a copy with top-level keys replaced (no recursive merge)."""
        d = self.to_dict()
        d.update(kwargs)
        return Config(d)

    def merged(self, other: Any) -> "Config":
        """Return a copy recursively merged with ``other`` (dict or Config).

        Like the reference's vendored yacs, unknown keys are *added* rather
        than rejected (reference ``lib/config/yacs.py:370-407``).
        """
        if isinstance(other, Config):
            other = other.to_dict()
        d = self.to_dict()
        _merge_into(d, other)
        return Config(d)

    def with_overrides(self, opts: List[str]) -> "Config":
        """Apply a flat [key, value, key, value, ...] CLI override list.

        Dotted keys address nested nodes; values are literal-eval'd when
        possible (so ``train.lr 5e-4`` and ``gpus [0,1]`` both work).
        """
        if not opts:
            return self
        if len(opts) % 2 != 0:
            raise ValueError(f"override list must have even length, got {opts}")
        d = self.to_dict()
        for key, raw in zip(opts[0::2], opts[1::2]):
            node = d
            parts = key.split(".")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
                if not isinstance(node, dict):
                    raise KeyError(f"cannot override through non-dict key {p!r} in {key!r}")
            node[parts[-1]] = _parse_literal(raw)
        return Config(d)


def _convert(v: Any) -> Any:
    if isinstance(v, dict):
        return Config(v)
    if isinstance(v, Config):
        return v
    if isinstance(v, list):
        return [_convert(x) for x in v]
    return v


def _merge_into(dst: Dict[str, Any], src: Dict[str, Any]) -> None:
    for k, v in src.items():
        if k in dst and isinstance(dst[k], dict) and isinstance(v, dict):
            _merge_into(dst[k], v)
        else:
            dst[k] = copy.deepcopy(v)


def _parse_literal(s: str) -> Any:
    try:
        return ast.literal_eval(s)
    except (ValueError, SyntaxError):
        return s


def load_yaml_config(path: str, defaults: Optional[Config] = None,
                     opts: Optional[List[str]] = None,
                     _depth: int = 0) -> Config:
    """Load a YAML config with ``parent_cfg`` inheritance + CLI overrides.

    Mirrors reference ``make_cfg`` (``lib/config/config.py:335-383``): parent
    merged first, then the file, then CLI opts.  Inheritance recurses so
    chains like monocap→zju377→default work (the reference only does one
    level because its chains are short; recursion is a strict superset).
    """
    if _depth > 8:
        raise RecursionError(f"parent_cfg chain too deep at {path}")
    with open(path, "r") as f:
        current = yaml.load(f, Loader=_YamlLoader) or {}

    base = defaults if defaults is not None else Config()
    if "parent_cfg" in current:
        parent_path = current["parent_cfg"]
        if not os.path.isabs(parent_path):
            # resolve relative to cwd first (reference behavior), else to the file
            if not os.path.exists(parent_path):
                cand = os.path.join(os.path.dirname(path), parent_path)
                if os.path.exists(cand):
                    parent_path = cand
        if os.path.exists(parent_path):
            base = load_yaml_config(parent_path, defaults=defaults, _depth=_depth + 1)

    cfg = base.merged(current)
    if opts:
        cfg = cfg.with_overrides(opts)
    return cfg


def finalize(cfg: Config) -> Config:
    """Derive dependent keys (reference ``parse_cfg``, lib/config/config.py:303-332).

    - ``num_latent_code`` defaults to ``num_train_frame``
    - ``eval_ratio`` defaults to ``ratio``
    - result/model/record dirs are namespaced by task/exp_name
    """
    updates: Dict[str, Any] = {}
    if cfg.get("num_latent_code", -1) is None or cfg.get("num_latent_code", -1) < 0:
        updates["num_latent_code"] = cfg.get("num_train_frame", 1)
    if cfg.get("eval_ratio", -1.0) < 0:
        updates["eval_ratio"] = cfg.get("ratio", 0.5)
    result_dir = os.path.join(cfg.get("result_dir", "exps"), cfg.get("task", "inb"),
                              cfg.get("exp_name", "default"))
    updates["result_dir"] = result_dir
    # honor an EXPLICIT trained_model_dir (e.g. a novel-pose eval config
    # that loads another experiment's checkpoint but writes its own
    # metrics); anything else — including the bare default — derives from
    # result_dir as the reference does
    if cfg.get("trained_model_dir", "") in ("", "data/trained_model"):
        updates["trained_model_dir"] = os.path.join(result_dir, "trained_model")
    updates["record_dir"] = os.path.join(result_dir, "record")
    return cfg.replace(**updates)


def dump_cfg(cfg: Config, result_dir: str) -> None:
    """Snapshot the merged config into the result dir at train start.

    Reference ``lib/utils/base_utils.py:22-30`` (dump_cfg) called from
    ``train_net.py:80-82``: writes ``config.yaml`` once (never overwrites a
    previous run's snapshot — continuing an experiment keeps its original
    record) plus a timestamped copy per invocation, so every run that
    touched the experiment is reproducible from its result dir.
    """
    import datetime

    def clean(v):
        if isinstance(v, Config):
            v = v.to_dict()          # Configs nested inside lists (stages)
        if isinstance(v, dict):
            return {k: clean(x) for k, x in v.items()}
        if isinstance(v, (list, tuple)):
            return [clean(x) for x in v]
        if hasattr(v, "item") and getattr(v, "ndim", 1) == 0:
            return v.item()          # numpy scalars
        return v

    os.makedirs(result_dir, exist_ok=True)
    text = yaml.safe_dump(clean(cfg.to_dict()), sort_keys=True)
    main_path = os.path.join(result_dir, "config.yaml")
    if not os.path.exists(main_path):
        with open(main_path, "w") as f:
            f.write(text)
    stamp = datetime.datetime.now().strftime("%Y-%m-%d_%H-%M-%S")
    with open(os.path.join(result_dir, f"{stamp}.yaml"), "w") as f:
        f.write(text)
