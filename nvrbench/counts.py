"""The benchmark's yardstick for work: the card's peaks, the least time of a
kernel call (its roofline bound), and the model FLOPs of a train step or a
render chunk, all computed from shapes and counts.

Peaks are NVIDIA's data sheet for one H100 SXM at its 700 W limit, dense
rates: 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32
outside them, 3.35 TB/s of HBM.  A kernel's bound is the larger of its
float32 operations over 67 TFLOP/s and its bytes over 3.35 TB/s, each input
read once and each output written once (``chip_smoke.py``'s rule, copied).

Model FLOPs (:func:`model_flops`) count what the model's mathematics needs
for the samples that survive, read from the step's or frame's cull
telemetry (``cull_need``: the share of samples within ``smpl_thresh``;
``part_need``: each part's share of the cull budget), capped at the
budgets, never the padded budgets themselves, and nothing recomputed:

  - the KNN blend: 8 operations a (surviving point, real vertex) pair;
  - each part's hash encoding: 8 corners x F features x 2 a level, and the
    deformer's, for every selected point of the part;
  - the occupancy and colour MLPs of the part and the deformer's MLP:
    2 x d_in x d_out a layer a selected point, in bf16 (the bf16 operands
    of ``models/nn.py``);
  - a train step adds twice the forward of the encodings and MLPs for the
    backward (no gradient flows into the KNN's inputs), and the patch loss's
    VGG19 to relu2_2: both images forward and the prediction's backward to
    its input, in float32.

Each count is a lower bound of the work the program does; the share of the
peak is the sum of each precision's FLOPs over its peak, over the time.

The table-gradient scatters of a train step (:func:`scatter_calls`): one
call for each table an encoding reads (one for each feature column of a
table read by columns), the part grids' over their budget slots, the
deformer's over every selected slot and again over the pair regularizer's
slots; a call of R records of F features into an (n_rows, F) table is
bounded by the keys (4 B) and bf16 payloads (2F B) read once and the bf16
table (2F B a row) written once (``chip_smoke.py``'s rule), and each route
('segmented', 'onehot') is the reference's ``grad_route``.

The fused hash-grid encoding (``hashgrid_encode_kernel``, one launch an
encoder call: the part grids', then the deformer's): a launch over M
points is bounded by the float32 points (12 B each) and each part's box
(24 B) read once, the distinct table rows it gathers read once, and the
(M, out_dim) float32 output written once (``chip_smoke.py`` phase 17's
rule).  :func:`encode_bounds` counts them while the reference renders the
same rays at the program's budgets: each call of its part grids'
``multi_hashgrid_encode`` and of its deformer's ``hashgrid_encode`` stands
for one launch, and the distinct rows are those of the reference's own
gathers.
"""
from __future__ import annotations

import contextlib
from typing import Dict, List, Sequence

PEAK_FLOPS = {"bf16": 989e12, "f32": 67e12}
HBM_BYTES_PER_S = 3.35e12
NUM_BONES = 24
# VGG19 up to relu2_2 (models/lpips.py:perceptual_loss): per stage
# (c_out, n_convs), a 2x2 max-pool between stages
VGG_STAGES = ((64, 2), (128, 2))


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` float32 operations
    and ``nbytes`` bytes of device memory."""
    return max(flops / PEAK_FLOPS["f32"], nbytes / HBM_BYTES_PER_S)


def knn_blend_bound_s(C: int, real: int, P: int, D: int = NUM_BONES) -> float:
    """Bound of one ``knn_blend`` call: C query points against ``real``
    vertices over P parts: 8 operations a (query, real vertex) pair; the
    queries, the vertices with their D blend weights and the lengths read
    once, the (C, P, D + 1) output written once."""
    return bound_s(8.0 * C * real, C * 12 + real * (12 + D * 4) + P * 4
                   + C * P * (D + 1) * 4)


def scatter_bound_s(R: int, F: int, n_rows: int) -> float:
    """Bound of one table-gradient scatter: R records of F bf16 features
    into an (n_rows, F) bf16 table."""
    return bound_s(float(R * F), R * 4 + R * F * 2 + n_rows * F * 2)


def hashgrid_encode_bound_s(points: int, n_parts: int, out_dim: int,
                            gathered_bytes: int) -> float:
    """Bound of one ``hashgrid_encode_kernel`` launch: ``points`` float32
    points and ``n_parts`` boxes read, ``gathered_bytes`` of distinct table
    rows read, the (points, out_dim) float32 output written."""
    return bound_s(0.0, 12 * points + 24 * n_parts + 4 * out_dim * points
                   + gathered_bytes)


# the fused kernel's launch that each of the reference's encoders stands for
ENCODERS = {"multi_hashgrid_encode": "parts", "hashgrid_encode": "deformer"}


@contextlib.contextmanager
def encode_bounds():
    """Inside it, the reference's hash-grid encodings are observed
    (``reference/ops/hashgrid.py:observe_encodes``); on leaving it, the list
    it yields holds (encoder, bound seconds) of each: 'parts' for a call of
    ``multi_hashgrid_encode``, 'deformer' for one of ``hashgrid_encode``,
    each one launch of the fused kernel (:func:`hashgrid_encode_bound_s`,
    rows from the reference's gathers)."""
    from .reference.ops import hashgrid
    launches: List = []
    with hashgrid.observe_encodes() as calls:
        yield launches
    launches += [(ENCODERS[encoder], hashgrid_encode_bound_s(points, boxes, out_dim, rows))
                 for encoder, points, boxes, out_dim, rows in calls]


def scatter_calls(spec, n_samples: int, pair_slots: int):
    """(route, R, F, n_rows) of every table-gradient scatter one train step
    over ``n_samples`` samples makes, in the reference's routing: the part
    grids' tables over their budget slots (in the gather dtype of
    ``grid_compute_dtype``), the deformer's float32 tables over every part
    slot and, with ``pair_slots``, over the pair regularizer's slots."""
    import torch
    from .reference.models.inb import budgets
    from .reference.ops import hashgrid
    _, Kps = budgets(spec, n_samples)
    part_dtype = torch.bfloat16 if spec.grid_compute_dtype == "bfloat16" else torch.float32

    def encode(hs, n_points, dtype):
        out = []
        for name, rows, level_offsets in hs.tables():
            plan = hashgrid.gather_plan(hs, rows)
            rounded = plan != "scalar" and not hs.exact_grads
            F = hs.n_features if plan == "rows" else 1
            n_lev = len(level_offsets) - 1
            route = hashgrid.grad_route(rows, F, level_offsets, dtype, rounded,
                                        hs.sorted_grads)
            call = (route, n_lev * 8 * n_points, F, rows)
            out += [call] * (hs.n_features if plan == "columns" else 1)
        return out

    calls = []
    for hs, kp in zip(spec.part_embeds, Kps):
        calls += encode(hs, kp, part_dtype)
    for n in (sum(Kps), pair_slots):
        if n:
            calls += encode(spec.deformer.embed, n, torch.float32)
    return calls


def mlp_flops(shapes: Sequence[Sequence[int]]) -> float:
    """FLOPs of one point through layers of weight shapes (..., d_in, d_out)."""
    return float(sum(2 * s[-2] * s[-1] for s in shapes))


def encode_flops(n_levels: int, n_features: int) -> float:
    return 8.0 * n_features * 2 * n_levels


def vgg_flops(side: int, c_in: int = 3) -> float:
    """Forward FLOPs of VGG19 to relu2_2 on one ``side`` x ``side`` image."""
    total, s = 0.0, side
    for i, (c_out, n) in enumerate(VGG_STAGES):
        for _ in range(n):
            total += 2.0 * s * s * 9 * c_in * c_out
            c_in = c_out
        if i < len(VGG_STAGES) - 1:
            s //= 2
    return total


def raised_spec(spec, mspec):
    """The reference's model spec ``spec`` at the budgets of the program's
    spec ``mspec`` (a renderer's, raised to cover the items)."""
    return spec._replace(cull_frac=float(mspec.cull_frac),
                         part_frac=float(mspec.part_frac),
                         part_budget_scales=tuple(float(s) for s in mspec.part_budget_scales))


def model_shapes(spec) -> Dict:
    """The layer shapes the FLOP count needs, from the reference's model
    built on the ``meta`` device (no memory)."""
    from .reference.models.inb import InbModel
    m = InbModel(spec, device="meta")
    groups = {}
    for (dh, nl), ids in spec.rgb_groups():
        for p in ids:
            groups[p] = [tuple(l.w.shape) for l in m.rgb[f"h{dh}_l{nl}"]]
    return {"occ": [tuple(l.w.shape) for l in m.occ],
            "rgb": groups,
            "deformer_mlp": [tuple(l.w.shape) for l in m.deformer.mlp],
            "part_enc": [(s.n_levels, s.n_features) for s in spec.part_embeds],
            "deformer_enc": (spec.deformer.embed.n_levels,
                             spec.deformer.embed.n_features)}


def model_flops(spec, shapes: Dict, n_samples: int, cull_need: float,
                part_need: Sequence[float], real_vertices: int,
                train: bool, patch_side: int = 0) -> Dict[str, float]:
    """Model FLOPs by precision (``bf16``, ``f32``) of one forward over
    ``n_samples`` samples (a train step's backward and patch loss with
    ``train``)."""
    from .reference.models.inb import budgets
    K, Kps = budgets(spec, n_samples)
    n_cull = min(cull_need * n_samples, K)
    sel = [min(float(pn) * K, kp) for pn, kp in zip(part_need, Kps)]
    bf16 = f32 = 0.0
    f32 += 8.0 * n_cull * real_vertices
    dl, df = shapes["deformer_enc"]
    enc = sum(n * encode_flops(*shapes["part_enc"][p]) for p, n in enumerate(sel))
    enc += sum(sel) * encode_flops(dl, df)
    mlp = sum(n * (mlp_flops([s[-2:] for s in shapes["occ"]])
                   + mlp_flops(shapes["rgb"][p])) for p, n in enumerate(sel))
    mlp += sum(sel) * mlp_flops(shapes["deformer_mlp"])
    passes = 3.0 if train else 1.0
    f32 += passes * enc
    bf16 += passes * mlp
    if train and patch_side:
        f32 += 3.0 * vgg_flops(patch_side)
    return {"bf16": bf16, "f32": f32}


def peak_seconds(flops: Dict[str, float]) -> float:
    """The least time of ``flops`` at each precision's peak."""
    return sum(v / PEAK_FLOPS[k] for k, v in flops.items())
