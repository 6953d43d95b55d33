"""The port's table-gradient scatter-adds (``instant_nvr_tpu_torch/ops/
scatter.py``) against the JAX package's, on the CPU.

The port's plain versions (f32 ``index_add_`` into zeros, cast to bf16) are
held against ``segmented_scatter_add_ref`` and against the Pallas kernels
``segmented_scatter_add`` and ``onehot_scatter_add`` run in interpret mode.
All sum bf16 payloads in float32, in different orders.  Tolerance, per
entry: one bf16 ulp of the larger result, plus 1e-5 x the sum of |payload|
landing on that entry (f32 summation-order error, which matters only where
the sum cancels).  The CUDA kernels are held against the same plain
versions on the card by ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nvr_tpu.ops.pallas import onehot_scatter as jonehot
from instant_nvr_tpu.ops.pallas import segmented_scatter as jseg
from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.ops import hashgrid as hg
from instant_nvr_tpu_torch.ops import scatter
from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
from instant_nvr_tpu_torch.train.step import table_grad_launches

PLAIN = {"segmented": scatter.segmented_scatter_add_plain,
         "onehot": scatter.onehot_scatter_add_plain}
H100_SMS = 132            # the H100 SXM's SM count, which the wrapper reads


def _records(rng, level_offsets, r_per_level, F, pileup=0.0, levels=None):
    """Level-major keys (each level's inside its window), bf16 payload.
    ``pileup``: share of each level's records on the level's first row + 7;
    ``levels``: windows that receive records (the others stay empty)."""
    L = len(level_offsets) - 1
    keys = []
    for l in range(L):
        lo, hi = level_offsets[l], level_offsets[l + 1]
        if levels is not None and l not in levels:
            lo, hi = level_offsets[levels[0]], level_offsets[levels[0] + 1]
        k = rng.integers(lo, hi, r_per_level)
        k[rng.random(r_per_level) < pileup] = lo + 7
        keys.append(k)
    keys = np.concatenate(keys).astype(np.int32)
    pay = rng.standard_normal((len(keys), F)).astype(np.float32)
    pay = np.array(jnp.asarray(pay, jnp.bfloat16).astype(jnp.float32))
    return keys, pay


def _port(kind, keys, pay, n_rows, level_offsets):
    out = PLAIN[kind](torch.from_numpy(keys),
                      torch.from_numpy(pay).to(torch.bfloat16), n_rows,
                      level_offsets)
    assert out.dtype == torch.bfloat16 and out.shape == (n_rows, pay.shape[1])
    return out.float().numpy()


def _check(got, want, keys, pay, n_rows):
    abs_sum = np.zeros((n_rows, pay.shape[1]), np.float64)
    np.add.at(abs_sum, keys, np.abs(pay))
    big = np.maximum(np.abs(got), np.abs(want))
    ulp = np.where(big > 0, 2.0 ** (np.floor(np.log2(np.maximum(big, 1e-38))) - 7), 0)
    err = np.abs(got.astype(np.float64) - want)
    bound = ulp + 1e-5 * abs_sum
    assert (err <= bound).all(), float((err - bound).max())
    # the cases must exercise the tolerance's first term, not be trivially 0
    assert np.abs(want).max() > 0


# (name, level_offsets, records per level, F, pileup, levels with records)
CASES = {
    "uniform-1-level": ((0, 50_000), 4096, 1, 0.0, None),
    "uniform-4-levels": ((0, 9_000, 20_000, 41_000, 65_000), 2048, 1, 0.0, None),
    "uniform-4-levels-F2": ((0, 9_000, 20_000, 41_000, 65_000), 2048, 2, 0.0, None),
    "pileup-past-refill-cap": ((0, 30_000, 65_000), 3 * jseg.CAP, 1, 0.9, None),
    "empty-levels": ((0, 16_000, 32_000, 48_000, 65_000), 1024, 2, 0.0, (1,)),
    "R-not-multiple-of-128": ((0, 4_000, 12_000, 40_000), 1001, 1, 0.0, None),
}


@pytest.mark.parametrize("kind", ["segmented", "onehot"])
@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_segmented_ref(rng, case, kind):
    offs, r_l, F, pileup, levels = CASES[case]
    keys, pay = _records(rng, offs, r_l, F, pileup, levels)
    n_rows = offs[-1]
    want = np.asarray(jseg.segmented_scatter_add_ref(
        jnp.asarray(keys), jnp.asarray(pay, jnp.bfloat16), n_rows), np.float32)
    _check(_port(kind, keys, pay, n_rows, offs), want, keys, pay, n_rows)


@pytest.mark.parametrize("case", list(CASES))
def test_plain_matches_segmented_kernel_interpret(rng, case):
    """The Pallas kernel needs a table padded to its 65,536-row tile (the
    port stores logical rows): padded on the JAX side, then cut off."""
    offs, r_l, F, pileup, levels = CASES[case]
    keys, pay = _records(rng, offs, r_l, F, pileup, levels)
    n_rows = offs[-1]
    t_pad = -(-n_rows // jseg.TILE_ROWS) * jseg.TILE_ROWS
    # the kernel sorts per level; empty windows leave one sorted stream
    n_lev = 1 if levels is not None else len(offs) - 1
    want = np.asarray(jseg.segmented_scatter_add(
        jnp.asarray(keys), jnp.asarray(pay, jnp.bfloat16), t_pad,
        n_levels=n_lev, interpret=True), np.float32)
    assert not want[n_rows:].any()
    _check(_port("segmented", keys, pay, n_rows, offs), want[:n_rows], keys,
           pay, n_rows)


ONEHOT_CASES = {
    # the flagship deformer's dense table, levels as its spec gives them
    "deformer-dense": ((0, 64, 189, 532, 1532, 4276, 12276), 2048, 1, 0.0),
    # the deformer's hash table: 2 levels x 16,411 rows
    "deformer-hash": ((0, 16_411, 32_822), 4096, 1, 0.0),
    "F2": ((0, 64, 189, 532, 1532, 4276, 12276), 1024, 2, 0.0),
    "pileup": ((0, 16_411, 32_822), 4096, 1, 0.9),
    "R-not-multiple-of-128": ((0, 8, 35, 28_143), 1001, 1, 0.0),
}


@pytest.mark.parametrize("case", list(ONEHOT_CASES))
def test_plain_matches_onehot_kernel_interpret(rng, case):
    offs, r_l, F, pileup = ONEHOT_CASES[case]
    keys, pay = _records(rng, offs, r_l, F, pileup)
    n_rows = offs[-1]
    want = np.asarray(jonehot.onehot_scatter_add(
        jnp.asarray(keys), jnp.asarray(pay, jnp.bfloat16), n_rows, offs,
        interpret=True), np.float32)
    _check(_port("onehot", keys, pay, n_rows, offs), want, keys, pay, n_rows)


def test_wrappers_run_plain_on_cpu_and_count_nothing(rng):
    offs = (0, 16_411, 32_822)
    keys, pay = _records(rng, offs, 512, 1)
    k, p = torch.from_numpy(keys), torch.from_numpy(pay).to(torch.bfloat16)
    before = (scatter.segmented_scatter_add.launches,
              scatter.onehot_scatter_add.launches)
    a = scatter.segmented_scatter_add(k, p, offs[-1], offs)
    b = scatter.onehot_scatter_add(k, p, offs[-1], offs)
    assert (scatter.segmented_scatter_add.launches,
            scatter.onehot_scatter_add.launches) == before
    want = scatter.segmented_scatter_add_plain(k, p, offs[-1])
    assert torch.equal(a, want) and torch.equal(b, want)
    for fn in (scatter.segmented_scatter_add, scatter.onehot_scatter_add):
        with pytest.raises(ValueError, match="cpu or cuda"):
            fn(k.to("meta"), p.to("meta"), offs[-1], offs)


@pytest.mark.parametrize("bad", ["keys-dtype", "payload-dtype", "F", "rows",
                                 "contiguous", "offsets"])
def test_kernel_argument_checks(bad):
    """What the CUDA kernels do not take is refused before any launch."""
    keys = torch.zeros(64, dtype=torch.int32)
    pay = torch.zeros((64, 2), dtype=torch.bfloat16)
    n_rows, offs = 100, (0, 50, 100)
    if bad == "keys-dtype":
        keys = keys.long()
    elif bad == "payload-dtype":
        pay = pay.float()
    elif bad == "F":
        pay = torch.zeros((64, 3), dtype=torch.bfloat16)
    elif bad == "rows":
        n_rows = 2 ** 30
    elif bad == "contiguous":
        pay = torch.zeros((2, 64), dtype=torch.bfloat16).T
    elif bad == "offsets":
        offs = (0, 70, 50, 100)
    with pytest.raises((ValueError, TypeError)):
        scatter._check_args("test", keys, pay, n_rows, offs)


def test_onehot_window_fit():
    """A window fits while rows x F x 4 B <= 232,448 B of shared memory;
    the wrapper's refusal names the sizes."""
    assert scatter.onehot_fits((0, 16_411, 32_822), 1)        # 64 KB
    assert scatter.onehot_fits((0, 58_112), 1)
    assert not scatter.onehot_fits((0, 58_113), 1)
    assert not scatter.onehot_fits((0, 16_411, 32_822), 4)
    with pytest.raises(ValueError, match="58113 rows x F=1"):
        scatter._check_onehot((0, 58_113), 1)
    scatter._check_onehot((0, 16_411, 32_822), 2)


def test_grad_routes_of_the_flagship():
    """inb_377: every table gradient takes a kernel: the big part tables
    the segmented one, the arms' dense tables and the deformer's columns
    the one-hot one; grid_compute_dtype float32 makes every one exact."""
    cfg = make_cfg("configs/inb/inb_377.yaml")
    mspec, rspec = inb.build_model_spec(cfg), make_render_spec(cfg)
    routes = {n: hg.encode_grad_routes(s, torch.bfloat16)
              for n, s in zip(mspec.partnames, mspec.part_embeds)}
    assert routes == {"body": ["segmented"] * 2, "leg": ["segmented"] * 2,
                      "head": ["segmented"] * 2,
                      "larm": ["onehot", "segmented"],
                      "rarm": ["onehot", "segmented"]}
    assert hg.encode_grad_routes(mspec.deformer.embed, torch.float32) == ["onehot"] * 4
    assert table_grad_launches(mspec, rspec) == {"segmented": 8, "onehot": 10}
    assert table_grad_launches(mspec, rspec._replace(use_pair_reg=False)) == \
        {"segmented": 8, "onehot": 6}
    f32 = inb.build_model_spec(cfg.merged({"grid_compute_dtype": "float32"}))
    assert table_grad_launches(f32, rspec) == {"exact": 18}


def test_grad_route_rules():
    lo = (0, 16_411, 32_822)
    assert hg.grad_route(32_822, 1, lo, torch.float32, False) == "exact"
    assert hg.grad_route(32_822, 1, lo, torch.float32, True) == "onehot"
    assert hg.grad_route(32_822, 1, lo, torch.bfloat16, False) == "onehot"
    big = (0, hg.KERNEL_MIN_ROWS)
    assert hg.grad_route(hg.KERNEL_MIN_ROWS, 1, big, torch.bfloat16, False) == "segmented"
    # a small table whose window does not fit a block takes the segmented kernel
    assert hg.grad_route(100_000, 4, (0, 100_000), torch.bfloat16, False) == "segmented"


def _flagship_onehot_tables():
    """(level_offsets, records per call) of the flagship's one-hot tables, as
    the train smoke calls them, and of the self-check's [1c] level."""
    cfg = make_cfg("configs/inb/inb_377.yaml")
    mspec = inb.build_model_spec(cfg)
    arm = mspec.part_embeds[mspec.partnames.index("larm")]
    dense, hashed = mspec.deformer.embed.tables()[0][2], mspec.deformer.embed.tables()[-1][2]
    return {"deformer-hash": (hashed, (len(hashed) - 1) * 8 * 22528),
            "deformer-dense": (dense, (len(dense) - 1) * 8 * 22528),
            "arm-dense": (arm.tables()[0][2], (len(arm.tables()[0][2]) - 1) * 8 * 2048),
            "selfcheck-1c": ((0, 12276), 1_081_344)}


@pytest.mark.parametrize("F", [1, 2])
@pytest.mark.parametrize("table", ["deformer-hash", "deformer-dense", "arm-dense",
                                   "selfcheck-1c"])
def test_onehot_plan_cluster_shapes(table, F):
    """Valid cluster shapes: at most 8 blocks a cluster, about BLOCK_ELEMS
    elements a block; a level that needs more than 8 blocks takes full
    clusters, no more than fill the card once and no more than its records
    need; the widest window x F floats of shared memory, within the card's
    232,448 B."""
    offs, R = _flagship_onehot_tables()[table]
    L = len(offs) - 1
    clusters, size, smem = scatter.onehot_plan(offs, R, F, H100_SMS)
    widest = max(b - a for a, b in zip(offs[:-1], offs[1:]))
    assert smem == widest * F * 4 <= scatter.ONEHOT_SMEM_BYTES
    need = -(-(R // L * F) // scatter.BLOCK_ELEMS)           # blocks a level needs
    assert 1 <= size <= scatter.CLUSTER_MAX and clusters >= 1
    if need <= scatter.CLUSTER_MAX:
        assert (clusters, size) == (1, need)
    else:
        assert size == scatter.CLUSTER_MAX
        assert clusters == 1 or clusters * size * L <= H100_SMS
        assert clusters * size < need + scatter.CLUSTER_MAX


def test_onehot_plan_of_the_main_path():
    """The deformer's hash levels spread over six clusters each (the
    workspace path), the arm's dense levels take one cluster of 4, [1c]
    fills the card; a smaller card gets fewer clusters."""
    tables = _flagship_onehot_tables()
    assert scatter.onehot_plan(*tables["deformer-hash"], 1, H100_SMS) == (6, 8, 16411 * 4)
    assert scatter.onehot_plan(*tables["arm-dense"], 1, H100_SMS)[:2] == (1, 4)
    assert scatter.onehot_plan((0, 12276), 1_081_344, 1, H100_SMS) == (16, 8, 12276 * 4)
    assert scatter.onehot_plan((0, 12276), 1_081_344, 2, H100_SMS) == (16, 8, 12276 * 8)
    assert scatter.onehot_plan((0, 12276), 1_081_344, 2, 66) == (8, 8, 12276 * 8)
    assert scatter.onehot_plan(*tables["deformer-hash"], 1, 16) == (1, 8, 16411 * 4)
    assert scatter.onehot_plan((0, 5, 10), 0, 1, H100_SMS) == (1, 1, 20)  # no records


@pytest.mark.parametrize("offs,F", [((0, 58_113), 1), ((0, 29_057), 2),
                                    (tuple(range(66)), 1)])
def test_onehot_plan_refuses(offs, F):
    """A window over 232,448 B of shared memory, or more than 64 levels."""
    with pytest.raises(ValueError, match="exceeds"):
        scatter.onehot_plan(offs, 65 * 1024, F, H100_SMS)


def test_workspace_grows_and_never_shrinks():
    dev, stream = torch.device("cpu"), -12345        # a key no wrapper uses
    try:
        a = scatter.workspace(dev, 100, stream)
        assert a.dtype == torch.float32 and a.numel() == 100 and not a.any()
        assert scatter.workspace(dev, 40, stream) is a
        b = scatter.workspace(dev, 300, stream)
        assert b.numel() == 300 and not b.any()
        assert scatter.workspace(dev, 100, stream) is b
        assert scatter.workspace(dev, 10, stream - 1) is not b    # per stream
        base = scatter.workspace_nonzero()
        b[7] = -0.0                            # a nonzero word, though == 0
        assert scatter.workspace_nonzero() == base + 1
    finally:
        for key in [k for k in scatter._workspaces if k[1] in (stream, stream - 1)]:
            del scatter._workspaces[key]


@pytest.mark.parametrize("F", [1, 2])
def test_wrappers_on_cpu_count_no_launch_and_hold_no_workspace(rng, F):
    offs = (0, 64, 189, 532, 1532)
    keys, pay = _records(rng, offs, 300, F)
    k, p = torch.from_numpy(keys), torch.from_numpy(pay).to(torch.bfloat16)
    before = (scatter.segmented_scatter_add.launches,
              scatter.onehot_scatter_add.launches, dict(scatter._workspaces))
    want = scatter.segmented_scatter_add_plain(k, p, offs[-1])
    for fn in (scatter.segmented_scatter_add, scatter.onehot_scatter_add):
        got = fn(k, p, offs[-1], offs)
        assert got.dtype == torch.bfloat16 and torch.equal(got, want)
    assert (scatter.segmented_scatter_add.launches,
            scatter.onehot_scatter_add.launches, scatter._workspaces) == before


def test_scatter_ab_loads_another_checkout(rng):
    """tools/kernel_ab loads a checkout's scatter module under another
    package name (here this checkout's own), whose kernels would build
    under that checkout; on CPU tensors its wrappers give the plain result."""
    import importlib
    import os
    import sys
    from instant_nvr_tpu_torch.tools import kernel_ab
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    try:
        other = kernel_ab.load_other(root, "scatter")
        assert other.__name__ == f"{kernel_ab.ALIAS}.ops.scatter"
        assert other is not scatter
        build = importlib.import_module(f"{kernel_ab.ALIAS}.cuda_build").BUILD_DIR
        assert str(build).startswith(root)
        offs = (0, 64, 189)
        keys, pay = _records(rng, offs, 100, 1)
        k, p = torch.from_numpy(keys), torch.from_numpy(pay).to(torch.bfloat16)
        for name in ("segmented_scatter_add", "onehot_scatter_add"):
            assert torch.equal(getattr(other, name)(k, p, offs[-1], offs),
                               getattr(scatter, name)(k, p, offs[-1], offs))
    finally:
        for name in [m for m in sys.modules if m.split(".")[0] == kernel_ab.ALIAS]:
            del sys.modules[name]
