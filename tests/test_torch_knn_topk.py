"""The unfused KNN route (``knn_topk`` + ``aggregate`` = ``knn_blend_unfused``)
of the port against the JAX package's, on the CPU.

References: the Pallas top-k kernel ``knn_topk_pallas`` run in interpret
mode (as tests/test_knn_pallas.py runs it), JAX's ``_aggregate``, its
unfused Pallas route ``knn_blend_weights_multiassign_pallas(fused=False)``
and its XLA path.  Tolerances:
  * top-k: real slots (a part's first min(length, 4)), sorted by (d2, idx),
    match in d2 at rtol 1e-6 (both compute (dx^2 + dy^2) + dz^2 in float32;
    XLA may round the sum differently by an ulp) and in indices, except
    where the two picks are equally near (an exact distance tie).  Spare
    slots differ by design (JAX: masked padded columns, d2 1e9, idx up to
    its padded M; the port: d2 1.5e9, idx 0): both have d2 >= 1e9.
  * aggregate on JAX's own (d, idx): rtol 1e-6 / atol 1e-7 (the same
    elementwise float32 math; exp may differ by an ulp).  That holds for
    torch's first parallel exp in a process only because importing the port
    picks MKL's kernels first (``instant_nvr_tpu_torch/__init__.py``);
    ``test_first_parallel_exp_is_high_accuracy`` holds that.
  * the unfused route: rtol 1e-3 / atol 1e-4 against JAX (the JAX suite's
    own between its routes); rtol 1e-5 against the port's fused plain
    version (the same neighbours and arithmetic).
The CUDA kernel ``csrc/knn_topk.cu`` is held against ``knn_topk_plain`` on
the card by chip_smoke.py and the self-check.
"""
import os
import shutil
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nvr_tpu.ops.knn import (_aggregate, knn_blend_weights_multiassign,
                                     knn_blend_weights_multiassign_pallas)
from instant_nvr_tpu.ops.pallas.knn_pallas import knn_topk_pallas
from instant_nvr_tpu_torch import cuda_build
from instant_nvr_tpu_torch.ops import knn

CASES = {
    # P, M, C, lengths
    "full": (5, 300, 256, [300, 200, 100, 150, 50]),
    "empty-and-padded": (5, 1100, 300, [300, 1100, 0, 0, 17]),
    "unaligned-C": (5, 257, 131, [257, 3, 64, 1, 200]),
    "fewer-than-K": (3, 2, 40, [2, 1, 0]),
}
RADIUS, EPS = 0.075, 1e-8


def _inputs(rng, P, M, C, lengths):
    return (rng.normal(size=(C, 3)).astype(np.float32),
            rng.normal(size=(P, M, 3)).astype(np.float32),
            rng.uniform(size=(P, M, 24)).astype(np.float32),
            np.asarray(lengths, np.int32))


def _jax_topk(q, pts, lengths):
    d2, idx = knn_topk_pallas(jnp.array(q), jnp.array(pts), jnp.array(lengths),
                              K=4, TQ=128, TV=256, interpret=True)
    return np.array(d2), np.array(idx)


def _sorted(d2, idx):
    """(P, C, K) slots ordered by (d2, idx)."""
    o = np.lexsort((idx, d2), axis=-1)
    return np.take_along_axis(d2, o, -1), np.take_along_axis(idx, o, -1)


def _torch(*arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize("case", list(CASES))
def test_topk_plain_matches_pallas_interpret(rng, case):
    q, pts, _, lengths = _inputs(rng, *CASES[case])
    P, M = pts.shape[:2]
    d2, idx = (a.numpy() for a in knn.knn_topk_plain(*_torch(q, pts, lengths)))
    assert d2.shape == idx.shape == (P, q.shape[0], 4)
    assert d2.dtype == np.float32 and idx.dtype == np.int32
    got_d2, got_i = _sorted(d2, idx)
    ref_d2, ref_i = _sorted(*_jax_topk(q, pts, lengths))
    for p in range(P):
        n = min(int(lengths[p]), 4)
        np.testing.assert_allclose(got_d2[p, :, :n], ref_d2[p, :, :n], rtol=1e-6)
        # indices: equal, or an equally near vertex (float64 distances)
        diff = got_i[p, :, :n] != ref_i[p, :, :n]
        if diff.any():
            c, k = np.nonzero(diff)
            dist = lambda i: ((q[c].astype(np.float64) - pts[p, i[c, k]]) ** 2).sum(-1)
            np.testing.assert_allclose(dist(got_i[p]), dist(ref_i[p]), rtol=1e-6)
        # spare slots: "no neighbour" on both sides; the port's are (1.5e9, 0)
        assert (ref_d2[p, :, n:] >= 1e9).all()
        assert (got_d2[p, :, n:] == knn.FAR_INIT).all()
        assert (got_i[p, :, n:] == 0).all()
        assert ((got_i[p] >= 0) & (got_i[p] < M)).all()


@pytest.mark.parametrize("case", list(CASES))
def test_aggregate_matches_jax(rng, case):
    """Fed JAX's own top-k output, padded-column indices >= M included."""
    q, pts, pbw, lengths = _inputs(rng, *CASES[case])
    d2, idx = _jax_topk(q, pts, lengths)
    d = np.sqrt(np.maximum(d2, 0.0))
    if case == "fewer-than-K":
        assert (idx >= pts.shape[1]).any()       # the clip is exercised
    ref = np.asarray(_aggregate(jnp.array(d), jnp.array(idx), jnp.array(pbw),
                                RADIUS, EPS))
    got = knn.aggregate(*_torch(d, idx, pbw), RADIUS, EPS).numpy()
    assert got.shape == ref.shape == (q.shape[0], pts.shape[0], 25)
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-7)


_FIRST_EXP = '''
import numpy as np, torch
import instant_nvr_tpu_torch
torch.set_num_threads(8)
x = torch.from_numpy(-np.random.default_rng(0).uniform(0, 87, 128_000).astype(np.float32))
first = torch.exp(x)                 # the process's first exp over 8 threads
torch.set_num_threads(1)
print(int((first != torch.exp(x)).sum()))
'''


def test_first_parallel_exp_is_high_accuracy():
    """A process's first torch.exp over OpenMP threads, after the port's
    import, equals a later one on one thread, bit for bit.  Without the
    import's warm-up, one thread's slice may come from MKL's AVX2
    enhanced-performance exp, up to 1.5e-4 off; 8 fresh processes started
    at once provoke that race, and this test then failed 4 runs of 10 on an
    8-core host.  Bit-equality: both calls take MKL's high-accuracy kernel,
    whose result for an element does not depend on how the array is split."""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen([sys.executable, "-c", _FIRST_EXP], env=env, cwd=root,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for _ in range(8)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [err[-2000:] for _, err in outs]
    assert [int(out.split()[-1]) for out, _ in outs] == [0] * 8


@pytest.mark.parametrize("ref", ["pallas-unfused", "xla"])
@pytest.mark.parametrize("case", list(CASES))
def test_unfused_matches_jax(rng, case, ref):
    q, pts, pbw, lengths = _inputs(rng, *CASES[case])
    args = [jnp.array(a) for a in (q, pts, pbw, lengths)]
    if ref == "xla":
        want = knn_blend_weights_multiassign(*args, chunk=128)
    else:
        want = knn_blend_weights_multiassign_pallas(*args, interpret=True,
                                                    fused=False)
    got = knn.knn_blend_unfused(*_torch(q, pts, pbw, lengths)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("case", list(CASES))
def test_unfused_matches_plain_blend(rng, case):
    q, pts, pbw, lengths = _torch(*_inputs(rng, *CASES[case]))
    got = knn.knn_blend_unfused(q, pts, pbw, lengths)
    assert got.is_contiguous()
    np.testing.assert_allclose(got.numpy(),
                               knn.knn_blend_plain(q, pts, pbw, lengths).numpy(),
                               rtol=1e-5)


def test_topk_wrapper_runs_plain_on_cpu_and_counts_nothing(rng):
    q, pts, _, lengths = _torch(*_inputs(rng, *CASES["empty-and-padded"]))
    before = knn.knn_topk.launches
    d2, idx = knn.knn_topk(q, pts, lengths)
    assert knn.knn_topk.launches == before
    want = knn.knn_topk_plain(q, pts, lengths)
    assert torch.equal(d2, want[0]) and torch.equal(idx, want[1])


def test_topk_wrapper_refuses_other_devices(rng):
    q, pts, _, lengths = _torch(*_inputs(rng, *CASES["full"]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        knn.knn_topk(q.to("meta"), pts, lengths)


@pytest.mark.parametrize("bad", ["K", "dtype", "lengths-dtype", "contiguous",
                                 "shape", "device"])
def test_topk_kernel_argument_checks(rng, bad):
    """What the top-k kernel does not take is refused before any launch."""
    q, pts, _, lengths = _torch(*_inputs(rng, *CASES["full"]))
    K = 4
    if bad == "K":
        K = 5
    elif bad == "dtype":
        pts = pts.double()
    elif bad == "lengths-dtype":
        lengths = lengths.long()
    elif bad == "contiguous":
        q = q.T.contiguous().T
    elif bad == "shape":
        lengths = lengths[:3].contiguous()
    elif bad == "device":
        lengths = lengths.to("meta")
    with pytest.raises((ValueError, TypeError)):
        knn._check_kernel_args(q, pts, None, lengths, K)


def test_library_path_hashes_headers(tmp_path, monkeypatch):
    """A changed header (the shared pass 1) names a new build of every
    kernel, so a stale library is never loaded."""
    csrc = tmp_path / "csrc"
    shutil.copytree(cuda_build.CSRC_DIR, csrc)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    before = {n: cuda_build.library_path(n) for n in cuda_build.KERNELS}
    assert before == {n: cuda_build.library_path(n) for n in cuda_build.KERNELS}
    header = csrc / "knn_select.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: cuda_build.library_path(n) for n in cuda_build.KERNELS}
    assert all(after[n] != before[n] for n in cuda_build.KERNELS)
    src = csrc / "knn_topk.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    assert cuda_build.library_path("knn_topk") != after["knn_topk"]
    assert cuda_build.library_path("knn_blend") == after["knn_blend"]


def test_kernel_ab_loads_another_checkouts_knn(rng):
    """tools/kernel_ab loads a checkout's KNN module under another package
    name (here this checkout's own), beside its scatter module from the same
    package; on CPU tensors its wrappers give the plain result, and another
    root while one is loaded is refused."""
    import os
    import sys
    from instant_nvr_tpu_torch.tools import kernel_ab
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        other = kernel_ab.load_other(root, "knn")
        assert other.__name__ == f"{kernel_ab.ALIAS}.ops.knn" and other is not knn
        scatter = kernel_ab.load_other(root, "scatter")
        assert scatter.__name__.startswith(kernel_ab.ALIAS)
        q, pts, pbw, lengths = _torch(*_inputs(rng, *CASES["empty-and-padded"]))
        assert torch.equal(other.knn_blend(q, pts, pbw, lengths),
                           knn.knn_blend(q, pts, pbw, lengths))
        for a, b in zip(other.knn_topk(q, pts, lengths), knn.knn_topk(q, pts, lengths)):
            assert torch.equal(a, b)
        with pytest.raises(RuntimeError):
            kernel_ab.load_other(os.path.join(root, "elsewhere"), "knn")
    finally:
        for name in [m for m in sys.modules if m.split(".")[0] == kernel_ab.ALIAS]:
            del sys.modules[name]
