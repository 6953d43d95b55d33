"""BENCHMARK.json against the benchmark's contract, and every name it holds
against the files the harness finds by name."""
import json
import re
from pathlib import Path

import pytest
import yaml

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["nvrbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_names_and_units():
    names = []
    for c in BENCH["configs"]:
        names.append(c["name"])
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in BENCH["workloads"]:
        names.append(w["name"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
    assert all(NAME.match(n) for n in names), names
    assert len(names) == len(set(names))


def test_entries_have_only_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer",
                                          "moves"}
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


def test_every_name_has_its_files():
    pkg = ROOT / "nvrbench"
    for c in BENCH["configs"]:
        doc = yaml.safe_load((ROOT / c["file"]).read_text())
        assert c["file"].startswith("nvrbench/")
        assert doc["source"] == c["source"] and doc["reduced"] == c["reduced"]
        assert {"config", "subject", "assumed"} <= set(doc)
    for w in BENCH["workloads"]:
        assert (pkg / "workloads" / f"{w['name']}.yaml").exists()
        assert (pkg / "traffic" / f"{w['traffic']}.py").exists()
        assert "limits" in yaml.safe_load((pkg / "workloads" / f"{w['name']}.yaml").read_text())
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (pkg / "metrics" / f"{m['name']}.py").exists(), m["name"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    from nvrbench.run import cell_metrics
    for w in BENCH["workloads"]:
        e2e = {m["name"] for m in cell_metrics(BENCH, w["name"], trace=False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell_metrics(BENCH, w["name"], trace=True)


@pytest.mark.parametrize("path", sorted(p.relative_to(ROOT).as_posix()
                                        for p in (ROOT / "nvrbench").rglob("*")
                                        if p.is_file() and "__pycache__" not in p.parts))
def test_file_names_use_name_characters(path):
    assert re.match(r"^[A-Za-z0-9_.\-/]+$", path)
