"""The whole run of every cell at small sizes on the CPU (``--device cpu``
with ``tiny.yaml``): the result line's keys and metrics, the sound run's
``correct``, and ``correct`` false under each fault the cell can have and
under the control, against the cells' committed limits.

Each case starts ``python3 -m nvrbench.run`` in a process of its own (the
no-JAX check runs there too); about 20 s a case.
"""
import json
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
KIND = {w["name"]: w["traffic"] for w in BENCH["workloads"]}
FAULTS = {"fit_stream": ("stale_state", "half_batch"),
          "fit_resident": ("stale_state", "half_batch"),
          "render_frames": ("altered_maps",)}
CONTROL = "float8_e4m3fn"


def run_cell(cell, *extra, trace=0, seed=1234567891):
    cmd = [sys.executable, "-m", "nvrbench.run", "--workload", cell,
           "--seed", str(seed), "--seconds", "1", "--trace", str(trace),
           "--device", "cpu", "--overrides", "nvrbench/tests/tiny.yaml", *extra]
    res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert res.returncode == 0, res.stderr[-3000:]
    line = json.loads(res.stdout.strip().splitlines()[-1])
    assert list(line)[-1] == "checks"
    return line


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("cell", CELLS)
def test_sound_run(cell, trace):
    from nvrbench.run import cell_metrics
    line = run_cell(cell, trace=trace)
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True and line["failed"] == 0
    assert line["device"]["platform"] == "cpu"
    want = {m["name"] for m in cell_metrics(BENCH, cell, bool(trace))}
    if not trace:                 # every end-to-end metric is there
        assert set(line["metrics"]) == want
    else:                         # the CPU has no device trace: host readings only
        assert set(line["metrics"]) <= want
    for name, m in line["metrics"].items():
        assert m["value"] > 0, name


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS for f in FAULTS[KIND[c]]])
def test_fault_is_not_correct(cell, fault):
    assert run_cell(cell, "--fault", fault)["correct"] is False


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    assert run_cell(cell, "--control", CONTROL)["correct"] is False


def test_no_result_without_the_program(tmp_path):
    """In a directory with only BENCHMARK.json and nvrbench/, a run exits
    non-zero and prints no result."""
    import shutil
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "nvrbench", tmp_path / "nvrbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    res = subprocess.run([sys.executable, "-m", "nvrbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "1", "--trace", "0",
                          "--device", "cpu"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=600)
    assert res.returncode != 0 and res.stdout.strip() == ""


@pytest.mark.card
def test_cell_on_the_card(card):
    """One short run of the first cell at its own size on the card."""
    res = subprocess.run([sys.executable, "-m", "nvrbench.run", "--workload", CELLS[0],
                          "--seed", "1", "--seconds", "2", "--trace", "0"], cwd=ROOT,
                         capture_output=True, text=True, timeout=1200)
    assert res.returncode == 0, res.stderr[-3000:]
    assert json.loads(res.stdout.strip().splitlines()[-1])["correct"] is True


def test_encoding_control_moves_the_numbers():
    """The bfloat16 encoding control runs end to end in the reference's
    place: on one seed its gaps lie far above the sound run's (at these
    tiny widths it stays inside the committed limits)."""
    sound = run_cell(CELLS[0])["checks"]
    ctl = run_cell(CELLS[0], "--control", "bfloat16_encoding")["checks"]
    assert ctl["grad_gap"]["value"] > 100 * max(sound["grad_gap"]["value"], 1e-9)
