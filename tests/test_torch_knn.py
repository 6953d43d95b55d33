"""KNN blend: the port's plain version against JAX, on the CPU.

The reference is the JAX package's XLA path and its Pallas kernel run in
interpret mode (as tests/test_knn_pallas.py runs it).  Tolerance rtol 1e-3 /
atol 1e-4, the JAX suite's own between those two: the XLA path computes
distances as |q|^2 + |v|^2 - 2 q.v and the Pallas kernel blends through
bf16 hi+lo halves (~1e-5 relative).  The port's CUDA kernel is held
against this plain version on the card by chip_smoke.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nvr_tpu.ops.knn import (knn_blend_weights_multiassign,
                                     knn_blend_weights_multiassign_pallas)
from instant_nvr_tpu_torch.ops import knn

TOL = dict(rtol=1e-3, atol=1e-4)

CASES = {
    # P, M, C, lengths
    "full": (5, 300, 256, [300, 200, 100, 150, 50]),
    "empty-and-padded": (5, 1100, 300, [300, 1100, 0, 0, 17]),
    "unaligned-C": (5, 257, 131, [257, 3, 64, 1, 200]),
    "fewer-than-K": (3, 2, 40, [2, 1, 0]),
}


def _inputs(rng, P, M, C, lengths):
    return (rng.normal(size=(C, 3)).astype(np.float32),
            rng.normal(size=(P, M, 3)).astype(np.float32),
            rng.uniform(size=(P, M, 24)).astype(np.float32),
            np.asarray(lengths, np.int32))


def _port(q, pts, pbw, lengths, **kw):
    return knn.knn_blend_plain(torch.from_numpy(q), torch.from_numpy(pts),
                               torch.from_numpy(pbw), torch.from_numpy(lengths),
                               **kw).numpy()


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_jax_xla(rng, case):
    q, pts, pbw, lengths = _inputs(rng, *CASES[case])
    ref = np.asarray(knn_blend_weights_multiassign(
        jnp.array(q), jnp.array(pts), jnp.array(pbw), jnp.array(lengths),
        chunk=128))
    got = _port(q, pts, pbw, lengths, chunk=100)
    assert got.shape == ref.shape == (q.shape[0], pts.shape[0], 25)
    np.testing.assert_allclose(got, ref, **TOL)


@pytest.mark.parametrize("case", ["full", "empty-and-padded", "unaligned-C"])
def test_plain_matches_pallas_interpret(rng, case):
    q, pts, pbw, lengths = _inputs(rng, *CASES[case])
    ref = np.asarray(knn_blend_weights_multiassign_pallas(
        jnp.array(q), jnp.array(pts), jnp.array(pbw), jnp.array(lengths),
        interpret=True))
    got = _port(q, pts, pbw, lengths)
    np.testing.assert_allclose(got, ref, **TOL)
    for p in np.flatnonzero(lengths == 0):
        # empty parts: zero blend, far distance
        np.testing.assert_array_equal(got[:, p, :24], 0.0)
        np.testing.assert_array_equal(got[:, p, 24], 1e6)


def test_far_rule_and_radius(rng):
    """Queries beyond 8 r of every vertex report 1e6; near ones do not."""
    P, M = 2, 50
    pts = rng.normal(scale=0.05, size=(P, M, 3)).astype(np.float32)
    pbw = rng.uniform(size=(P, M, 24)).astype(np.float32)
    q = np.concatenate([np.zeros((4, 3)), np.full((4, 3), 5.0)]).astype(np.float32)
    lengths = np.array([M, M], np.int32)
    for radius in (0.05, 0.2):
        got = _port(q, pts, pbw, lengths, radius=radius)
        ref = np.asarray(knn_blend_weights_multiassign(
            jnp.array(q), jnp.array(pts), jnp.array(pbw), jnp.array(lengths),
            radius=radius))
        np.testing.assert_allclose(got, ref, **TOL)
        assert (got[4:, :, 24] == 1e6).all() and (got[:4, :, 24] < 1.0).all()


def test_wrapper_runs_plain_on_cpu_and_counts_nothing(rng):
    q, pts, pbw, lengths = _inputs(rng, *CASES["full"])
    before = knn.knn_blend.launches
    got = knn.knn_blend(torch.from_numpy(q), torch.from_numpy(pts),
                        torch.from_numpy(pbw), torch.from_numpy(lengths))
    assert knn.knn_blend.launches == before
    np.testing.assert_array_equal(got.numpy(), _port(q, pts, pbw, lengths))
    assert knn.knn_blend_weights_multiassign is knn.knn_blend


def test_wrapper_refuses_other_devices(rng):
    q, pts, pbw, lengths = (torch.from_numpy(a) for a in
                            _inputs(rng, *CASES["full"]))
    with pytest.raises(ValueError, match="cpu or cuda"):
        knn.knn_blend(q.to("meta"), pts, pbw, lengths)


@pytest.mark.parametrize("bad", ["K", "dtype", "lengths-dtype", "contiguous",
                                 "shape", "device"])
def test_kernel_argument_checks(rng, bad):
    """What the CUDA kernel does not take is refused before any launch."""
    q, pts, pbw, lengths = (torch.from_numpy(a) for a in
                            _inputs(rng, *CASES["full"]))
    K = 4
    if bad == "K":
        K = 5
    elif bad == "dtype":
        pbw = pbw.double()
    elif bad == "lengths-dtype":
        lengths = lengths.long()
    elif bad == "contiguous":
        pts = pts.transpose(0, 1).contiguous().transpose(0, 1)
    elif bad == "shape":
        pbw = pbw[:, :10]
    elif bad == "device":
        lengths = lengths.to("meta")
    with pytest.raises((ValueError, TypeError)):
        knn._check_kernel_args(q, pts, pbw.contiguous() if bad == "shape" else pbw,
                               lengths, K)
