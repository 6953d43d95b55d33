"""Leaf ops of the PyTorch port against the JAX package, on the CPU.

Inputs are made with numpy from a seed and fed to both.  Unless a case says
otherwise the tolerance is float32 rounding (rtol 1e-5, atol 1e-6): both
sides run the same elementwise ops in the same order, and only the order of
a short sum (a 3- to 24-wide contraction, a reduction) may differ.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nvr_tpu.models import embedders as jemb
from instant_nvr_tpu.models import nn as jnn
from instant_nvr_tpu.ops import grid_sample as jgs
from instant_nvr_tpu.ops import lbs as jlbs
from instant_nvr_tpu.ops import math as jmath
from instant_nvr_tpu.ops import ray as jray
from instant_nvr_tpu.ops import rendering as jrend
from instant_nvr_tpu.ops import select as jsel
from instant_nvr_tpu_torch.models import embedders, nn
from instant_nvr_tpu_torch.ops import grid_sample, lbs, math, ray, rendering, select

F32 = dict(rtol=1e-5, atol=1e-6)


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def close(got, ref, **tol):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(ref),
                               **(tol or F32))


def _transforms(rng, n=24):
    """Well-conditioned (n, 4, 4) rigid-ish transforms."""
    A = np.tile(np.eye(4, dtype=np.float32), (n, 1, 1))
    A[:, :3, :3] += 0.2 * rng.normal(size=(n, 3, 3)).astype(np.float32)
    A[:, :3, 3] = rng.normal(size=(n, 3)).astype(np.float32)
    return A


def _blend(rng, B=2, N=50):
    bw = rng.uniform(size=(B, N, 24)).astype(np.float32)
    return bw / bw.sum(-1, keepdims=True)


# -- math / lbs ---------------------------------------------------------------

def test_inverse_3x3_and_safe_norm(rng):
    m = (np.eye(3) + 0.3 * rng.normal(size=(7, 5, 3, 3))).astype(np.float32)
    # the adjugate divides by det + eps: relative error grows with 1/det
    close(math.inverse_3x3(T(m)), jmath.inverse_3x3(jnp.array(m)),
          rtol=1e-4, atol=1e-5)
    x = rng.normal(size=(9, 3)).astype(np.float32)
    x[0] = 0.0
    close(math.safe_norm(T(x), dim=-1, keepdim=True),
          jmath.safe_norm(jnp.array(x), axis=-1, keepdims=True))


@pytest.mark.parametrize("name", ["world_points_to_pose_points",
                                  "pose_points_to_world_points"])
def test_world_pose_points(rng, name):
    pts = rng.normal(size=(2, 40, 3)).astype(np.float32)
    R = _transforms(rng, 2)[:, :3, :3]
    Th = rng.normal(size=(2, 1, 3)).astype(np.float32)
    close(getattr(lbs, name)(T(pts), T(R), T(Th)),
          getattr(jlbs, name)(jnp.array(pts), jnp.array(R), jnp.array(Th)))


def test_world_dirs_to_pose_dirs(rng):
    d = rng.normal(size=(2, 40, 3)).astype(np.float32)
    R = _transforms(rng, 2)[:, :3, :3]
    close(lbs.world_dirs_to_pose_dirs(T(d), T(R)),
          jlbs.world_dirs_to_pose_dirs(jnp.array(d), jnp.array(R)))


def test_blend_and_inverse_blend_params(rng):
    bw = _blend(rng)
    A = np.stack([_transforms(rng), _transforms(rng)])
    close(lbs.blend_transforms(T(bw), T(A)),
          jlbs.blend_transforms(jnp.array(bw), jnp.array(A)))
    A_bw, R_inv = lbs.inverse_blend_params(T(bw), T(A))
    jA_bw, jR_inv = jlbs.inverse_blend_params(jnp.array(bw), jnp.array(A))
    close(A_bw, jA_bw)
    close(R_inv, jR_inv, rtol=1e-4, atol=1e-5)   # adjugate / det


@pytest.mark.parametrize("name", ["pose_points_to_tpose_points",
                                  "pose_dirs_to_tpose_dirs",
                                  "tpose_points_to_pose_points",
                                  "tpose_dirs_to_pose_dirs"])
def test_point_and_dir_transforms(rng, name):
    bw = _blend(rng)
    A = T(np.stack([_transforms(rng), _transforms(rng)]))
    A_bw, R_inv = lbs.inverse_blend_params(T(bw), A)
    x = rng.normal(size=(2, 50, 3)).astype(np.float32)
    jA, jR = jnp.array(A_bw.numpy()), jnp.array(R_inv.numpy())
    if name == "pose_points_to_tpose_points":
        got, ref = lbs.pose_points_to_tpose_points(T(x), A_bw, R_inv), \
            jlbs.pose_points_to_tpose_points(jnp.array(x), jA, jR)
    elif name == "pose_dirs_to_tpose_dirs":
        got, ref = lbs.pose_dirs_to_tpose_dirs(T(x), R_inv), \
            jlbs.pose_dirs_to_tpose_dirs(jnp.array(x), jR)
    else:
        got = getattr(lbs, name)(T(x), A_bw)
        ref = getattr(jlbs, name)(jnp.array(x), jA)
    close(got, ref)


def test_part_tables_match():
    assert lbs.PARTNAMES == jlbs.PARTNAMES
    assert lbs.NUM_BONES == jlbs.NUM_BONES
    assert lbs.PART_BW_MAP == jlbs.PART_BW_MAP


# -- rays / compositing --------------------------------------------------------

@pytest.mark.parametrize("n_samples", [8, 64])
def test_stratified_z_vals_and_points(rng, n_samples):
    near = rng.uniform(0.5, 1.0, size=(33,)).astype(np.float32)
    far = near + rng.uniform(0.1, 1.0, size=(33,)).astype(np.float32)
    z = ray.stratified_z_vals(T(near), T(far), n_samples)
    jz = jray.stratified_z_vals(None, jnp.array(near), jnp.array(far),
                                n_samples, perturb=False)
    close(z, jz)
    o = rng.normal(size=(33, 3)).astype(np.float32)
    d = rng.normal(size=(33, 3)).astype(np.float32)
    close(ray.z_to_points(T(o), T(d), z),
          jray.z_to_points(jnp.array(o), jnp.array(d), jz))


def test_host_ray_helpers_are_the_jax_ones(rng):
    K = np.array([[100.0, 0, 16], [0, 100.0, 16], [0, 0, 1]])
    R, Tc = np.eye(3), np.array([[0.0], [0.0], [2.0]])
    for a, b in zip(ray.get_rays_np(32, 32, K, R, Tc),
                    jray.get_rays_np(32, 32, K, R, Tc)):
        np.testing.assert_array_equal(a, b)
    o, d = jray.get_rays_np(32, 32, K, R, Tc)
    bounds = np.array([[-0.3] * 3, [0.3] * 3], np.float32)
    for a, b in zip(ray.get_near_far_np(bounds, o.reshape(-1, 3), d.reshape(-1, 3)),
                    jray.get_near_far_np(bounds, o.reshape(-1, 3), d.reshape(-1, 3))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("bg", [None, 1.0])
def test_volume_rendering(rng, bg):
    rgb = rng.uniform(size=(17, 64, 3)).astype(np.float32)
    alpha = rng.uniform(0, 0.3, size=(17, 64)).astype(np.float32)
    got = rendering.volume_rendering(T(rgb), T(alpha), bg_brightness=bg)
    ref = jrend.volume_rendering(jnp.array(rgb), jnp.array(alpha),
                                 bg_brightness=bg)
    for g, r in zip(got, ref):
        # a 64-long cumulative product: allow its rounding to accumulate
        close(g, r, rtol=1e-5, atol=1e-5)


# -- grid sampling ------------------------------------------------------------

@pytest.mark.parametrize("padded", [False, True])
def test_pts_sample_volume(rng, padded):
    vol = rng.normal(size=(12, 10, 14, 25)).astype(np.float32)
    sizes = np.array([9, 7, 11], np.int32) if padded else None
    bounds = np.array([[-0.5, -0.4, -0.6], [0.5, 0.6, 0.4]], np.float32)
    # some points outside the bounds exercise the border clamp
    pts = rng.uniform(-0.7, 0.7, size=(300, 3)).astype(np.float32)
    got = grid_sample.pts_sample_volume(
        T(pts), T(vol), T(bounds), sizes=None if sizes is None else T(sizes))
    ref = jgs.pts_sample_volume(jnp.array(pts), jnp.array(vol),
                                jnp.array(bounds),
                                sizes=None if sizes is None else jnp.array(sizes))
    close(got, ref)


# -- selection ----------------------------------------------------------------

@pytest.mark.parametrize("budget,frac_inf", [(128, 0.0), (128, 0.7), (256, 0.5)])
def test_topk_select_and_scatter_back(rng, budget, frac_inf):
    """Compared by the selected valid set: ties (the inf scores of invalid
    slots) may be ordered differently by torch.topk and lax.top_k."""
    n = 400
    score = rng.uniform(0, 0.2, size=n).astype(np.float32)
    score[rng.uniform(size=n) < frac_inf] = np.inf
    idx, valid = select.topk_select(T(score), budget, 0.1)
    jidx, jvalid = jsel.topk_select(jnp.array(score), budget, 0.1)
    idx, valid = idx.numpy(), valid.numpy()
    jidx, jvalid = np.asarray(jidx), np.asarray(jvalid)
    assert set(idx[valid].tolist()) == set(jidx[jvalid].tolist())
    assert valid.sum() == jvalid.sum()

    # each side scatters the values of the points it selected, in its own
    # slot order: the results must be identical
    row_vals = rng.normal(size=(n, 4)).astype(np.float32)
    full = np.zeros((n, 4), np.float32)
    got = select.scatter_back(T(full), torch.from_numpy(idx), T(row_vals[idx]),
                              torch.from_numpy(valid))
    ref = jsel.scatter_back(jnp.array(full), jnp.array(jidx),
                            jnp.array(row_vals[jidx]), jnp.array(jvalid))
    close(got, ref, rtol=0, atol=0)


# -- embedders / MLPs ---------------------------------------------------------

@pytest.mark.parametrize("multires", [1, 4, 10])
def test_freq_encode(rng, multires):
    x = rng.normal(size=(5, 7, 3)).astype(np.float32)
    assert embedders.freq_out_dim(multires) == jemb.freq_out_dim(multires)
    # sin/cos of arguments up to 2^9 * |x|: libm and XLA's range reductions
    # differ by a few float32 ulp of the argument
    close(embedders.freq_encode(T(x), multires),
          jemb.freq_encode(jnp.array(x), multires), rtol=1e-5, atol=1e-4)


def _stacked_layers(rng, P, dims):
    layers = []
    for a, b in zip(dims[:-1], dims[1:]):
        bound = 1 / np.sqrt(a)
        layers.append({"w": rng.uniform(-bound, bound, (P, a, b)).astype(np.float32),
                       "b": rng.uniform(-bound, bound, (P, b)).astype(np.float32)})
    return layers


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("stacked", [True, False])
def test_mlp_apply(rng, dtype, stacked):
    P, N, dims = 3, 50, [35, 64, 64, 17]
    layers_np = _stacked_layers(rng, P, dims)
    x = rng.normal(size=(P, N, dims[0])).astype(np.float32)
    mods = nn.make_mlp(dims[0], dims[-1], 64, 2, n_experts=P)
    with torch.no_grad():
        for m, l in zip(mods, layers_np):
            m.w.copy_(T(l["w"]))
            m.b.copy_(T(l["b"]))
    cd_t = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    cd_j = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    jl = [{k: jnp.array(v) for k, v in l.items()} for l in layers_np]
    with torch.no_grad():
        if stacked:
            got = nn.mlp_apply_stacked(mods, T(x), cd_t)
            ref = jnn.mlp_apply_stacked(jl, jnp.array(x), cd_j)
        else:
            plain = nn.make_mlp(dims[0], dims[-1], 64, 2)
            for m, m3 in zip(plain, mods):
                m.w.copy_(m3.w[1])
                m.b.copy_(m3.b[1])
            got = nn.mlp_apply(plain, T(x[1]), cd_t)
            ref = jnn.mlp_apply([{k: v[1] for k, v in l.items()} for l in jl],
                                jnp.array(x[1]), cd_j)
    # f32: sum order only.  bf16: operands round identically and products
    # are exact, but a last-ulp f32 difference in a hidden activation can
    # flip its bf16 rounding (2^-8 relative) before the next layer
    tol = F32 if dtype == "float32" else dict(rtol=2e-2, atol=2e-3)
    close(got, ref, **tol)
