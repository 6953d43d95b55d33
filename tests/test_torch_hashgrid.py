"""Hash-grid encoders of the port against the JAX package, on the CPU.

Both sides get the same tables (drawn by JAX's init) and the same points.
The gathers are exact and the lerp accumulates in float32 on both sides, so
the tolerance is float32 rounding of the 8-corner and feature sums, whose
order XLA's fusion picks (rtol 1e-5, atol 1e-6 on outputs of magnitude
~0.1), with bf16 tables as well: the bf16 values are the same, and a
bf16 x f32 product is exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nvr_tpu.ops import hashgrid as jhg
from instant_nvr_tpu_torch.ops import hashgrid as hg

PRIMES = (1, 19349663, 83492791)
TOL = dict(rtol=1e-5, atol=1e-6)

# jit: one compile per spec instead of one per primitive
jax_encode = jax.jit(jhg.hashgrid_encode, static_argnums=0)
jax_multi_encode = jax.jit(jhg.multi_hashgrid_encode, static_argnums=(0, 4))

MODES = {
    # the flagship deformer grid: dense + hashed levels, F=2, concat
    "deformer": dict(n_levels=8, n_features_per_level=2, log2_hashmap_size=14,
                     base_resolution=4, b=1.38, sum=False),
    # a part grid: scalar table (one value per row), F * q forward
    "scalar-part": dict(n_levels=8, n_features_per_level=4,
                        log2_hashmap_size=10, base_resolution=4, b=1.38),
    # the same grid with (rows, F) tables
    "sum-features": dict(n_levels=8, n_features_per_level=4,
                         log2_hashmap_size=10, base_resolution=4, b=1.38,
                         scalar_tables=False),
    "sum-levels": dict(n_levels=6, n_features_per_level=3, log2_hashmap_size=9,
                       base_resolution=3, b=1.5, sum_over_features=False,
                       include_input=False),
}


def _specs(kw):
    return (jhg.make_hashgrid_spec(primes=PRIMES, **kw),
            hg.make_hashgrid_spec(primes=PRIMES, **kw))


def _tables(jspec, seed, dtype):
    jp = jhg.hashgrid_init(jax.random.key(seed), jspec)
    np_tab = {k: np.array(v) for k, v in jp.items()}
    jd = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    td = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    return ({k: v.astype(jd) for k, v in jp.items()},
            {k: torch.from_numpy(v).to(td) for k, v in np_tab.items()})


def test_spec_fields_match():
    for kw in MODES.values():
        jspec, spec = _specs(kw)
        for f in hg.HashGridSpec._fields:
            assert getattr(spec, f) == getattr(jspec, f), f
        assert spec.out_dim == jspec.out_dim
        assert spec.dense_rows == max(jspec.dense_total, 1)


def test_hash_index_bit_exact(rng):
    idx = [rng.integers(0, 2 ** 21, size=(4, 8, 300)) for _ in range(3)]
    for T in (1031, 16411, 1048583):
        got = hg._hash_index([torch.from_numpy(i) for i in idx], PRIMES, T)
        iu = [i.astype(np.uint32) for i in idx]
        ref = ((iu[0] * np.uint32(PRIMES[0])) ^ (iu[1] * np.uint32(PRIMES[1]))
               ^ (iu[2] * np.uint32(PRIMES[2]))) % np.uint32(T)
        np.testing.assert_array_equal(got.numpy(), ref.astype(np.int64))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("mode", list(MODES))
def test_hashgrid_encode(rng, mode, dtype):
    jspec, spec = _specs(MODES[mode])
    jp, tp = _tables(jspec, 1, dtype)
    bounds = np.array([[-0.4, -0.5, -0.3], [0.6, 0.5, 0.7]], np.float32)
    # 10% outside the bounds on each side: truncation toward zero + clipping
    xyz = rng.uniform(-0.5, 0.8, size=(257, 3)).astype(np.float32)
    got = hg.hashgrid_encode(spec, tp, torch.from_numpy(xyz),
                             torch.from_numpy(bounds))
    ref = jax_encode(jspec, jp, jnp.array(xyz), jnp.array(bounds))
    assert got.shape == ref.shape == (257, jspec.out_dim)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


PART_KW = [dict(base_resolution=16, log2_hashmap_size=12),
           dict(base_resolution=2, log2_hashmap_size=12),
           dict(base_resolution=2, log2_hashmap_size=10),
           dict(base_resolution=2, log2_hashmap_size=8),
           dict(base_resolution=2, log2_hashmap_size=8)]


# non-scalar bf16 grids are left out: JAX sums their features in bf16
# (instant_nvr_tpu/ops/hashgrid.py:623) and the port in f32 (ROADMAP C2)
@pytest.mark.parametrize("scalar,dtype", [(True, "float32"), (True, "bfloat16"),
                                          (False, "float32")])
def test_multi_hashgrid_encode(rng, scalar, dtype):
    """Five part grids of different sizes (the flagship's layout, narrowed):
    dense + hashed levels, scalar tables."""
    common = dict(n_levels=10, n_features_per_level=4, b=1.38,
                  scalar_tables=scalar)
    pairs = [_specs(dict(common, **kw)) for kw in PART_KW]
    jspecs = tuple(j for j, _ in pairs)
    specs = tuple(s for _, s in pairs)
    assert all(s.start_hash > 0 and s.n_hash_levels > 0 for s in specs)
    tabs = [_tables(j, 10 + i, dtype) for i, j in enumerate(jspecs)]
    seg = (64, 48, 32, 16, 16)
    bounds = np.stack([np.stack([c - 0.4, c + 0.4]) for c in
                       rng.uniform(-0.3, 0.3, size=(5, 3))]).astype(np.float32)
    pid = np.repeat(np.arange(5), seg)
    pts = (bounds[pid, 0] + rng.uniform(-0.05, 1.05, size=(len(pid), 3))
           * (bounds[pid, 1] - bounds[pid, 0])).astype(np.float32)
    got = hg.multi_hashgrid_encode(specs, [t for _, t in tabs],
                                   torch.from_numpy(pts),
                                   torch.from_numpy(bounds), seg)
    ref = jax_multi_encode(jspecs, [j for j, _ in tabs], jnp.array(pts),
                           jnp.array(bounds), seg)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # and it equals the per-part single-grid encoder
    offs = np.cumsum((0,) + seg)
    for p in range(5):
        single = hg.hashgrid_encode(specs[p], tabs[p][1],
                                    torch.from_numpy(pts[offs[p]:offs[p + 1]]),
                                    torch.from_numpy(bounds[p]))
        np.testing.assert_allclose(got[offs[p]:offs[p + 1]].numpy(),
                                   single.numpy(), **TOL)


def test_init_distribution():
    """Same distributions as the JAX init (not the same values)."""
    for kw, scalar in ((MODES["deformer"], False), (MODES["scalar-part"], True)):
        _, spec = _specs(kw)
        tabs = hg.HashTables(spec)
        tabs.reset_parameters(torch.Generator().manual_seed(0))
        std = np.sqrt(2.0 / (spec.table_size * spec.n_features))
        if scalar:
            std /= np.sqrt(spec.n_features)
        h = tabs.hash.detach().numpy()
        assert h.shape == ((spec.hash_rows,) if scalar
                           else (spec.hash_rows, spec.n_features))
        assert abs(h.std() / std - 1) < 0.05 and abs(h.mean()) < 0.05 * std
