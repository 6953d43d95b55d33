"""The harness's weights: the reference's init with every hash table
redrawn at the configuration's measured scales (``common.harness_weights``),
the same tensors for the program and the reference, seed by seed."""
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch
import yaml

from nvrbench import common
from nvrbench.reference.models import inb

ROOT = Path(__file__).resolve().parents[2]
TINY = "nvrbench/tests/tiny_model.yaml"
LEVEL_RMS = [0.01, 0.3, 2.0, 0.05]


def ctx_for(seed, scales_path):
    return SimpleNamespace(args=SimpleNamespace(seed=seed), device=torch.device("cpu"),
                           root=ROOT, doc={"table_scales": str(scales_path)})


@pytest.fixture
def scales(tmp_path):
    spec = inb.build_model_spec(common.reference_config(TINY))
    doc = {"tables": {name: {"rms": LEVEL_RMS[:len(offs) - 1]}
                      for name, offs in common.hash_tables(spec)}}
    path = tmp_path / "scales.yaml"
    path.write_text(yaml.safe_dump(doc))
    return path


def test_same_tensors_for_a_seed_and_others_across_seeds(scales):
    a = common.harness_weights(ctx_for(2 ** 31 + 7, scales), TINY)
    b = common.harness_weights(ctx_for(2 ** 31 + 7, scales), TINY)
    c = common.harness_weights(ctx_for(2 ** 31 + 8, scales), TINY)
    assert list(a) == list(b) == list(c)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a if a[k].numel() > 1)
    # the program's model takes the same tensors
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.run import build
    _, _, model = build(make_cfg(TINY), torch.device("cpu"), seed=0)
    model.load_state_dict(a)
    assert all(torch.equal(model.state_dict()[k], a[k]) for k in a)


def test_tables_take_the_stated_rms_level_by_level(scales):
    spec = inb.build_model_spec(common.reference_config(TINY))
    w = common.harness_weights(ctx_for(12345, scales), TINY)
    for name, offs in common.hash_tables(spec):
        for level, (lo, hi) in enumerate(zip(offs[:-1], offs[1:])):
            x = w[name][lo:hi].double()
            n = x.numel()
            rms = float(x.pow(2).mean().sqrt())
            # the RMS of n normal draws: relative standard error 1 / sqrt(2n)
            assert abs(rms / LEVEL_RMS[level] - 1) < 5 / (2 * n) ** 0.5, (name, level, n)
            assert abs(float(x.mean())) < 5 * LEVEL_RMS[level] / n ** 0.5


def test_the_rest_of_the_init_is_unchanged(scales):
    """The MLPs, latent codes and occupancy bias are the reference's init
    from the same generator, as before the tables were redrawn."""
    seed = 99
    w = common.harness_weights(ctx_for(seed, scales), TINY)
    spec = inb.build_model_spec(common.reference_config(TINY))
    gen = torch.Generator().manual_seed(common.derive(seed, "weights"))
    init = inb.init_params(spec, gen, torch.device("cpu")).state_dict()
    tables = {n for n, _ in common.hash_tables(spec)}
    rest = [k for k in init if k not in tables]
    assert "latent" in rest and "occ.1.b" in rest
    assert all(torch.equal(w[k], init[k]) for k in rest)
    assert all(not torch.equal(w[k], init[k]) for k in tables)


def test_scales_must_match_the_tables(tmp_path, scales):
    doc = yaml.safe_load(scales.read_text())
    doc["tables"].popitem()
    short = tmp_path / "short.yaml"
    short.write_text(yaml.safe_dump(doc))
    with pytest.raises(ValueError, match="scales name"):
        common.harness_weights(ctx_for(1, short), TINY)
    doc = yaml.safe_load(scales.read_text())
    next(iter(doc["tables"].values()))["rms"].append(1.0)
    extra = tmp_path / "extra.yaml"
    extra.write_text(yaml.safe_dump(doc))
    with pytest.raises(ValueError, match="levels"):
        common.harness_weights(ctx_for(1, extra), TINY)


@pytest.mark.parametrize("config", ["inb377", "lan"])
def test_each_configuration_states_the_scales_of_its_tables(config, tmp_path):
    doc = yaml.safe_load((ROOT / "nvrbench" / "configs" / f"{config}.yaml").read_text())
    scales = yaml.safe_load((ROOT / doc["table_scales"]).read_text())["tables"]
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(doc["config"]))
    tables = common.hash_tables(inb.build_model_spec(common.reference_config(str(path))))
    assert sorted(scales) == sorted(n for n, _ in tables)
    for name, offs in tables:
        assert len(scales[name]["rms"]) == len(offs) - 1
        assert all(s > 0 for s in scales[name]["rms"])


def test_measured_rms_level_by_level_by_hand():
    """``measure_scales.level_rms`` over a table of two levels (rows 0:2 and
    2:5): the first level's entries 3 and -4 (RMS sqrt(12.5)), the second's
    1, 1, 1 and -1, -1, -1 over two columns (RMS 1)."""
    from nvrbench.measure_scales import level_rms
    table = torch.tensor([[3.0, 3.0], [-4.0, -4.0], [1.0, -1.0], [1.0, -1.0], [1.0, -1.0]])
    assert level_rms(table, (0, 2, 5)) == pytest.approx([12.5 ** 0.5, 1.0])
    assert level_rms(table[:, 0], (0, 2, 5)) == pytest.approx([12.5 ** 0.5, 1.0])
