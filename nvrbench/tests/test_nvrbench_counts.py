"""The yardstick's arithmetic against hand counts on small shapes."""
import math

import pytest

from nvrbench import counts
from nvrbench.fitcore import percentile, spread
from nvrbench.readers import idle_share, mfu, roofline_share
from types import SimpleNamespace


def test_bound_takes_the_larger_side():
    assert counts.bound_s(67e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 3.35e12) == pytest.approx(1.0)
    assert counts.bound_s(67e9, 3.35e12) == pytest.approx(1.0)


def test_knn_blend_bound_by_hand():
    # C=2 queries, 3 real vertices over P=1 part, D=24 weights
    flops = 8 * 2 * 3
    nbytes = 2 * 12 + 3 * (12 + 96) + 4 + 2 * 1 * 25 * 4
    assert counts.knn_blend_bound_s(2, 3, 1) == pytest.approx(
        max(flops / 67e12, nbytes / 3.35e12))


def test_mlp_and_encode_flops_by_hand():
    assert counts.mlp_flops([(4, 8), (8, 2)]) == 2 * 4 * 8 + 2 * 8 * 2
    assert counts.mlp_flops([(5, 4, 8)]) == 2 * 4 * 8      # stacked experts: per point
    assert counts.encode_flops(16, 2) == 16 * 8 * 2 * 2


def test_vgg_flops_by_hand():
    # 4x4 image: stage 1 two convs at 4x4, pool, stage 2 two convs at 2x2
    s1 = 2 * 16 * 9 * (3 * 64 + 64 * 64)
    s2 = 2 * 4 * 9 * (64 * 128 + 128 * 128)
    assert counts.vgg_flops(4) == s1 + s2


def test_peak_seconds_sums_precisions():
    assert counts.peak_seconds({"bf16": 989e12, "f32": 67e12}) == pytest.approx(2.0)


def test_model_flops_counts_survivors_not_budgets():
    from nvrbench.reference.config import make_cfg
    from nvrbench.reference.models import inb
    cfg = make_cfg("nvrbench/tests/tiny_model.yaml")
    spec = inb.build_model_spec(cfg)
    shapes = counts.model_shapes(spec)
    n = 4096
    none = counts.model_flops(spec, shapes, n, 0.0, [0.0] * 5, 100, train=False)
    assert none == {"bf16": 0.0, "f32": 0.0}
    some = counts.model_flops(spec, shapes, n, 0.1, [0.5] + [0.0] * 4, 100, train=False)
    K, Kps = inb.budgets(spec, n)
    n_cull = min(0.1 * n, K)
    sel = min(0.5 * K, Kps[0])
    per_point = (counts.mlp_flops([s[-2:] for s in shapes["occ"]])
                 + counts.mlp_flops(shapes["rgb"][0])
                 + counts.mlp_flops(shapes["deformer_mlp"]))
    assert some["bf16"] == pytest.approx(sel * per_point)
    enc = sel * (counts.encode_flops(*shapes["part_enc"][0])
                 + counts.encode_flops(*shapes["deformer_enc"]))
    assert some["f32"] == pytest.approx(8 * n_cull * 100 + enc)
    train = counts.model_flops(spec, shapes, n, 0.1, [0.5] + [0.0] * 4, 100,
                               train=True, patch_side=4)
    assert train["bf16"] == pytest.approx(3 * some["bf16"])
    assert train["f32"] == pytest.approx(8 * n_cull * 100 + 3 * enc
                                         + 3 * counts.vgg_flops(4))


def test_model_flops_at_raised_budgets():
    """``part_need`` is a share of the budgets the program ran at: counted
    at a renderer's raised budgets (``raised_spec``), the same telemetry
    gives more survivors than at the configuration's."""
    from nvrbench.reference.config import make_cfg
    from nvrbench.reference.models import inb
    spec = inb.build_model_spec(make_cfg("nvrbench/tests/tiny_model.yaml"))
    shapes = counts.model_shapes(spec)
    n = 4096
    program = spec._replace(cull_frac=min(1.0, 2 * spec.cull_frac), part_frac=1.0)
    raised = counts.raised_spec(spec, program)
    assert (raised.cull_frac, raised.part_frac) == (program.cull_frac, 1.0)
    assert raised.part_embeds == spec.part_embeds
    K0, _ = inb.budgets(spec, n)
    K1, Kps1 = inb.budgets(raised, n)
    assert K1 > K0
    cull_need, part_need = 0.4, [0.9] + [0.0] * 4
    low = counts.model_flops(spec, shapes, n, cull_need, part_need, 100, train=False)
    high = counts.model_flops(raised, shapes, n, cull_need, part_need, 100, train=False)
    sel = min(0.9 * K1, Kps1[0])
    per_point = (counts.mlp_flops([s[-2:] for s in shapes["occ"]])
                 + counts.mlp_flops(shapes["rgb"][0])
                 + counts.mlp_flops(shapes["deformer_mlp"]))
    assert high["bf16"] == pytest.approx(sel * per_point)
    assert high["bf16"] > low["bf16"] and high["f32"] > low["f32"]


def test_percentile_and_spread():
    xs = [float(i) for i in range(1, 101)]
    assert percentile(xs, 95) == pytest.approx(95.05)
    assert percentile([3.0], 95) == 3.0
    assert percentile([1.0, 2.0], 50) == 1.5
    # statistics.quantiles' exclusive method: 1..9 -> Q1 2.5, Q2 5, Q3 7.5
    assert spread([float(i) for i in range(1, 10)]) == pytest.approx(1.0)


def test_shares_from_readings():
    r = SimpleNamespace(trace={"busy_s": 0.75, "window_s": 1.0,
                               "kernel_s": {"knn_blend_kernel(float)": 0.01}},
                        trace_units=10, flops={"bf16": 989e9, "f32": 0.0})
    assert idle_share(r) == pytest.approx(25.0)
    # 10 calls of a 0.5 ms bound in 10 ms of kernel time
    assert roofline_share(r, "knn_blend_kernel", 0.5e-3) == pytest.approx(50.0)
    assert roofline_share(r, "absent_kernel", 0.5e-3) is None
    # 1 ms at the bf16 peak a unit, 100 ms a unit
    assert mfu(r) == pytest.approx(1.0)
    assert math.isfinite(mfu(r))


@pytest.mark.parametrize("min_rows", [190_000, 1_000])
def test_scatter_calls_match_the_encoders_backward(monkeypatch, min_rows):
    """``scatter_calls`` against the table gradients the reference's
    encoders compute in one backward: the part grids over their budget
    slots, the deformer's over every slot and over the pair slots (with a
    lower row threshold, some tables take the segmented route)."""
    import torch
    from collections import Counter
    from nvrbench.reference.config import make_cfg
    from nvrbench.reference.models import inb
    from nvrbench.reference.ops import hashgrid
    monkeypatch.setattr(hashgrid, "KERNEL_MIN_ROWS", min_rows)
    spec = inb.build_model_spec(make_cfg("nvrbench/tests/tiny_model.yaml"))
    gen = torch.Generator().manual_seed(3)
    model = inb.init_params(spec, gen, torch.device("cpu"))
    n, pair = 2048, 96
    _, Kps = inb.budgets(spec, n)
    seen = []
    table_grad = hashgrid._table_grad

    def record(idx, g, n_rows, level_offsets, table_dtype, allow_rounded, sorted_grads):
        seen.append((hashgrid.grad_route(n_rows, g.shape[1], level_offsets, table_dtype,
                                         allow_rounded, sorted_grads),
                     idx.numel(), g.shape[1], n_rows))
        return table_grad(idx, g, n_rows, level_offsets, table_dtype, allow_rounded,
                          sorted_grads)

    monkeypatch.setattr(hashgrid, "_table_grad", record)
    bounds = torch.tensor([[[-1.0] * 3, [1.0] * 3]] * len(Kps))
    pts = torch.rand((sum(Kps), 3), generator=gen) * 1.8 - 0.9
    emb = hashgrid.multi_hashgrid_encode(spec.part_embeds, inb._cast_tables(spec, model),
                                         pts, bounds, Kps)
    unit = torch.tensor([[0.0] * 3, [1.0] * 3])
    loss = emb.float().sum()
    for m in (sum(Kps), pair):
        uvt = torch.rand((m, 3), generator=gen)
        loss = loss + hashgrid.hashgrid_encode(spec.deformer.embed,
                                               model.deformer.embed.tables(), uvt, unit).sum()
    loss.backward()
    want = counts.scatter_calls(spec, n, pair)
    assert Counter(seen) == Counter(want)
    assert len(want) == len(seen) > 0
    assert ("segmented" in {c[0] for c in want}) == (min_rows < 190_000)


def test_scatter_bound_by_hand():
    # 10 records of F=2 into 100 rows: keys, payloads and the bf16 table
    assert counts.scatter_bound_s(10, 2, 100) == pytest.approx(
        max(20 / 67e12, (10 * 4 + 10 * 2 * 2 + 100 * 2 * 2) / 3.35e12))


def test_scatter_roofline_readers_match_their_kernels_only():
    import importlib.util
    from pathlib import Path
    kernel_s = {"(anonymous namespace)::red_kernel(int const*, float*)": 0.002,
                "(anonymous namespace)::exchange_kernel(int const*, float*)": 0.002,
                "void at::native::scattered_kernel<float>(float*)": 0.5,
                "(anonymous namespace)::onehot_cluster_kernel(int const*)": 0.001}
    r = SimpleNamespace(kind="fit", trace={"kernel_s": kernel_s}, trace_units=2,
                        scatter_bound_s={"segmented": 1e-3, "onehot": 0.25e-3})
    got = {}
    for name in ("segmented_scatter_roofline.fit", "onehot_scatter_roofline.fit"):
        path = Path(counts.__file__).parent / "metrics" / f"{name}.py"
        spec = importlib.util.spec_from_file_location(name.replace(".", "_"), path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        got[name] = mod.read(r)
    # 2 steps of a 1 ms bound in 4 ms of red + exchange; 2 x 0.25 ms in 1 ms
    assert got["segmented_scatter_roofline.fit"] == pytest.approx(50.0)
    assert got["onehot_scatter_roofline.fit"] == pytest.approx(50.0)
    r.kind = "render"
    assert mod.read(r) is None


def test_hashgrid_encode_bound_by_hand():
    # 10 points of 2 parts into a 5-wide output, 100 B of distinct rows
    assert counts.hashgrid_encode_bound_s(10, 2, 5, 100) == pytest.approx(
        (10 * 12 + 2 * 24 + 10 * 5 * 4 + 100) / 3.35e12)


def test_encode_bounds_count_each_launch_by_hand():
    """Two dense levels of 2^3 and 3^3 rows (offsets 0 and 8): points in
    [0.05, 0.2]^3 touch one cell of each level, 8 + 8 rows; points all over
    the box touch every row, 8 + 27.  The part grids (scalar float32 rows,
    4 B) and the deformer (F = 2 float32 columns, 8 B a row) each count as
    one launch, and nothing is observed after the block."""
    import torch
    from nvrbench.reference.models import deformer, inb
    from nvrbench.reference.ops import hashgrid
    kw = dict(n_levels=2, n_features_per_level=2, log2_hashmap_size=6,
              base_resolution=2, b=1.5)
    part = hashgrid.make_hashgrid_spec(**kw)
    grid = hashgrid.make_hashgrid_spec(**kw, sum=False)
    assert part.scalar and not grid.scalar and part.dense_total == 35
    assert [t[0] for t in part.tables()] == ["dense"]
    gen = torch.Generator().manual_seed(0)
    corner = 0.05 + 0.15 * torch.rand((50, 3), generator=gen)
    spread_ = 0.01 + 0.98 * torch.rand((400, 3), generator=gen)
    unit = torch.tensor([[0.0] * 3, [1.0] * 3])
    tables = lambda s: hashgrid.hashgrid_init(s, gen, "cpu")   # noqa: E731
    with counts.encode_bounds() as launches:
        inb.multi_hashgrid_encode([part, part], [tables(part), tables(part)],
                                  torch.cat([corner, spread_]), torch.stack([unit, unit]),
                                  [50, 400])
        deformer.hashgrid_encode(grid, tables(grid), corner, unit)
    deformer.hashgrid_encode(grid, tables(grid), corner, unit)
    assert hashgrid._OBSERVED is None and len(launches) == 2
    parts = 450 * 12 + 2 * 24 + 450 * (2 + 3) * 4 + (16 + 35) * 4
    grid_b = 50 * 12 + 24 + 50 * (2 * 2 + 3) * 4 + 16 * 8
    assert [e for e, _ in launches] == ["parts", "deformer"]
    assert [s for _, s in launches] == pytest.approx([parts / 3.35e12, grid_b / 3.35e12])


def test_hashgrid_roofline_reader_takes_the_fused_kernel_only():
    import importlib.util
    from pathlib import Path
    path = Path(counts.__file__).parent / "metrics" / "hashgrid_encode_roofline.render.py"
    spec = importlib.util.spec_from_file_location("hashgrid_roofline", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    kernel_s = {"hashgrid_encode_kernel(Params, float const*, float*)": 0.004,
                "void at::native::index_elementwise_kernel<float>(float*)": 0.5}
    r = SimpleNamespace(kind="render", trace={"kernel_s": kernel_s}, trace_units=2,
                        encode_bound_s=0.5e-3)
    # 2 frames of a 0.5 ms bound in 4 ms of the kernel
    assert mod.read(r) == pytest.approx(25.0)
    r.encode_bound_s = None
    assert mod.read(r) is None
    r.kind, r.encode_bound_s = "fit", 0.5e-3
    assert mod.read(r) is None
