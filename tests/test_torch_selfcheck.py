"""The port's on-card self-check (``instant_nvr_tpu_torch/tools/
cuda_selfcheck.py``) on the CPU, at its TINY sizes.

On the CPU every kernel wrapper runs its plain version, so each check must
pass with the gates of ``tools/tpu_selfcheck.py`` (KNN agreement >= 99.5%
at rtol 1e-3 / atol 1e-4; segmented scatter max error <= 0.05 x max(1,
|ref|max); one-hot relative error <= 0.05; the train loss finite and
falling); a corrupted input must make its check fail and ``main`` exit 1.
The card runs it at full sizes through chip_smoke.py phase 7.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from instant_nvr_tpu_torch import cuda_build
from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.ops import knn
from instant_nvr_tpu_torch.tools import cuda_selfcheck as sc
from instant_nvr_tpu_torch.train_net import TINY

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TAGS = ["[1]", "[1]", "[1b]", "[1b-scalar]", "[1c]", "[1c-scalar]", "[2]", "[3]"]


def _run(name, rng):
    if name == "train":
        cfg = make_cfg(str(sc.FLAGSHIP_CFG)).merged(TINY)
        return sc.check_train(CPU, cfg, tiny=True, **sc.TINY["train"])
    return getattr(sc, f"check_{name}")(CPU, rng, **sc.TINY[name])


@pytest.mark.parametrize("name", ["knn", "segmented", "onehot", "matmul", "train"])
def test_check_passes_on_cpu(rng, name):
    checks = _run(name, rng)
    assert checks and all(c.ok and not c.failure for c in checks), checks
    for c in checks:
        assert c.line.startswith(c.tag + " ") and c.numbers
        assert all(np.isfinite(v) for v in c.numbers.values())
    if name == "knn":
        assert [c.numbers["agreement"] for c in checks] == [1.0, 1.0]
    if name == "train":
        n = checks[0].numbers
        assert n["loss_last"] < n["loss_first"] and n["ms_per_step"] > 0


def _flip_lengths(monkeypatch):
    """The top-k route sees the parts' lengths in reverse order."""
    topk = knn.knn_topk
    monkeypatch.setattr(knn, "knn_topk",
                        lambda q, pts, lengths, K=4: topk(q, pts, lengths.flip(0), K))


def test_corrupted_lengths_fail_check_1(rng, monkeypatch):
    _flip_lengths(monkeypatch)
    unfused, fused = sc.check_knn(CPU, rng, **sc.TINY["knn"])
    assert not unfused.ok and "topk+gather" in unfused.failure
    assert unfused.numbers["agreement"] < 0.995
    assert fused.ok


def test_main_passes_on_cpu(capsys):
    assert sc.main(["--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("device: cpu")
    assert [ln.split(" ")[0] for ln in lines[1:9]] == TAGS
    assert lines[-1] == "all self-checks passed"


def test_main_lists_failures_and_exits_1(capsys, monkeypatch):
    _flip_lengths(monkeypatch)
    assert sc.main(["--device", "cpu"]) == 1
    out = capsys.readouterr().out
    assert "FAILURES:" in out and "all self-checks passed" not in out
    assert " - KNN (topk+gather) disagrees" in out
    assert "(fused) disagrees" not in out


def test_main_defaults_to_the_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            sc.main([])


def test_selfcheck_never_imports_jax():
    code = ("import sys\n"
            "import instant_nvr_tpu_torch.tools.cuda_selfcheck\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'jaxlib', 'instant_nvr_tpu.')) or m in "
            "('instant_nvr_tpu', '__graft_entry__'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


def test_topk_kernel_built_without_fma():
    """The top-k kernel's distances must round like knn_topk_plain's."""
    assert "--fmad=false" in cuda_build.KERNELS["knn_topk"]
    assert "--fmad=false" in cuda_build.KERNELS["knn_blend"]
    for name in ("knn_topk", "knn_blend"):
        src = (cuda_build.CSRC_DIR / f"{name}.cu").read_text()
        assert '#include "knn_select.cuh"' in src
