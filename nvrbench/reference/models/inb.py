"""The flagship model: part-wise hash-grid dynamic-human NeRF, forward
(port of ``instant_nvr_tpu/models/inb.py``).

  world pts -> pose space -> SMPL-distance cull (fixed budget)
  -> per-part KNN blend weights (the CUDA kernel, ops/knn.py)
  -> inverse LBS to bigpose -> UV-deformer residual -> fused 5-part hash
  encoding -> stacked occupancy / colour MLPs -> max-occupancy aggregation
  -> scatter back to the full sample set.

Every shape is fixed per chunk; validity masks carry the sparsity, so the
forward never waits on the device for a count.  The part tables are cast
to the gather dtype in the forward; the JAX package's bf16 table shadow
only fuses that cast into its Adam update and gives the same numbers.
Every budget is kept nearest first (``select_mode: topk``, the only mode
this copy of the reference keeps).  Parameters live in :class:`InbModel`
under the JAX tree's names.
"""
from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..ops import lbs
from ..ops.grid_sample import pts_sample_volume
from ..ops.hashgrid import (HashGridSpec, HashTables, make_hashgrid_spec,
                            multi_hashgrid_encode)
from ..ops.knn import knn_blend
from ..ops.select import scatter_back, topk_select
from ..utils.constants import arange, device_constant
from .deformer import Deformer, DeformerSpec, deformer_apply, make_deformer_spec
from .embedders import freq_encode, freq_out_dim
from .nn import kaiming_normal_, make_mlp, mlp_apply_stacked

SELECT_MODES = ("topk",)


def _round_budget(n: int, mult: int = 128) -> int:
    return max(mult, ((int(n) + mult - 1) // mult) * mult)


def budgets(spec: "ModelSpec", n_samples: int) -> Tuple[int, Tuple[int, ...]]:
    """(K, Kps): the cull budget for ``n_samples`` samples and each part's
    budget; part p's selected points are its leading Kp slots."""
    K = min(_round_budget(spec.cull_frac * n_samples), _round_budget(n_samples))
    return K, tuple(min(_round_budget(spec.part_frac * s * K), K)
                    for s in spec.part_budget_scales[:spec.num_parts])


class ModelSpec(NamedTuple):
    """Static model description (the JAX ModelSpec; its ``knn_backend`` is
    only checked, by :func:`_check_knn_backend`: the port has one KNN route
    per device)."""
    partnames: Tuple[str, ...]
    part_embeds: Tuple[HashGridSpec, ...]
    rgb_archs: Tuple[Tuple[int, int], ...]   # per part (d_hidden, n_layers)
    occ_arch: Tuple[int, int]
    geo_feature_dim: int
    latent_dim: int
    num_latent: int
    viewdir_res: int
    deformer: DeformerSpec
    aggr: str                   # '' (max-occupancy winner) | 'mean' | 'dist'
    smpl_thresh: float
    knn_k: int
    knn_radius: float
    knn_chunk: int              # query chunk of the plain (CPU) KNN
    cull_frac: float
    part_frac: float
    part_budget_scales: Tuple[float, ...]
    tpose_viewdir: bool
    compute_dtype: str          # 'bfloat16' | 'float32' for MLP matmuls
    grid_compute_dtype: str     # part-table gather dtype (params stay f32)
    select_mode: str = "topk"   # 'topk' (ops/select.py)

    @property
    def num_parts(self) -> int:
        return len(self.partnames)

    @property
    def embed_dim(self) -> int:
        return self.part_embeds[0].out_dim

    @property
    def cdtype(self) -> torch.dtype:
        # float8_e4m3fn: the benchmark's control, one precision below bf16
        return {"bfloat16": torch.bfloat16,
                "float8_e4m3fn": torch.float8_e4m3fn}.get(self.compute_dtype,
                                                          torch.float32)

    def rgb_groups(self) -> List[Tuple[Tuple[int, int], Tuple[int, ...]]]:
        """[(arch, part_ids)] grouped by identical colour-head architecture."""
        groups: Dict[Tuple[int, int], List[int]] = {}
        for i, arch in enumerate(self.rgb_archs):
            groups.setdefault(arch, []).append(i)
        return [(arch, tuple(ids)) for arch, ids in groups.items()]


def _check_knn_backend(cfg) -> None:
    """``auto`` and ``pallas`` both mean knn_blend's kernel on the card;
    any other value raises, naming the key."""
    backend = cfg.get("knn_backend", "auto")
    if backend in ("auto", "pallas"):
        return
    if backend == "xla":
        raise ValueError(
            "knn_backend: xla asks for the KNN route without a kernel; the port "
            "has one KNN route per device (knn_blend's kernel on the card, its "
            "plain version on the CPU): set auto or pallas")
    raise ValueError(f"knn_backend: {backend!r} is none of auto, pallas")


def _select_mode(cfg) -> str:
    mode = cfg.get("select_mode", "topk")
    if mode not in SELECT_MODES:
        raise ValueError(f"select_mode: {mode!r} is none of {', '.join(SELECT_MODES)}")
    return mode


def build_model_spec(cfg) -> ModelSpec:
    """Assemble the spec from an inb YAML config (as the JAX version does).
    ``fix_random`` routes every table gradient that the atomic kernels
    would take through the sorted-segment kernel (``ops/hashgrid.py:
    grad_route``)."""
    _check_knn_backend(cfg)
    primes = tuple(cfg.ps)
    partnames = tuple(lbs.PARTNAMES)
    # scalar grids are exact only for Adam with zero weight decay
    scalar_ok = (cfg.train.get("optim", "adam") == "adam"
                 and not cfg.train.get("weight_decay", 0.0)
                 and cfg.get("scalar_tables", True))
    # full-precision runs keep exact f32 table gradients (ops/hashgrid.py)
    exact = cfg.get("grid_compute_dtype", "bfloat16") == "float32"
    sorted_grads = bool(cfg.get("fix_random", False))
    default_color = (cfg.network.color.d_hidden, cfg.network.color.n_layers)
    part_embeds, rgb_archs = [], []
    for p in partnames:
        node = cfg.partnet[p]
        part_embeds.append(make_hashgrid_spec(primes=primes,
                                              scalar_tables=scalar_ok,
                                              exact_grads=exact,
                                              sorted_grads=sorted_grads,
                                              **node.embedder.kwargs.to_dict()))
        if "color_network" in node and "kwargs" in node.color_network:
            kw = node.color_network.kwargs
            rgb_archs.append((kw.d_hidden, kw.n_layers))
        else:
            rgb_archs.append(default_color)
    deformer = make_deformer_spec(cfg.tpose_deformer.embedder.kwargs.to_dict(),
                                  primes, scalar_ok=scalar_ok, exact_grads=exact,
                                  sorted_grads=sorted_grads)
    return ModelSpec(
        partnames=partnames,
        part_embeds=tuple(part_embeds),
        rgb_archs=tuple(rgb_archs),
        occ_arch=(cfg.network.occ.d_hidden, cfg.network.occ.n_layers),
        geo_feature_dim=cfg.geo_feature_dim,
        latent_dim=cfg.latent_code_dim,
        num_latent=cfg.num_latent_code,
        viewdir_res=cfg.viewdir_embedder.kwargs.res,
        deformer=deformer,
        aggr=cfg.aggr,
        smpl_thresh=cfg.smpl_thresh,
        knn_k=cfg.knn_k,
        knn_radius=cfg.knn_radius,
        knn_chunk=cfg.knn_chunk,
        cull_frac=cfg.cull_budget,
        part_frac=cfg.part_budget,
        part_budget_scales=tuple(cfg.get("part_budget_scales",
                                         [1.0, 0.75, 0.5, 0.25, 0.25])),
        tpose_viewdir=cfg.tpose_viewdir,
        compute_dtype=cfg.mlp_dtype,
        grid_compute_dtype=cfg.get("grid_compute_dtype", "bfloat16"),
        select_mode=_select_mode(cfg),
    )


# --------------------------------------------------------------------------
# parameters
# --------------------------------------------------------------------------

class InbModel(nn.Module):
    """All parameters, named like the JAX tree: ``embed.<part>.dense|hash``,
    ``occ.<layer>.w|b`` (stacked over parts), ``rgb.h<d>_l<n>.<layer>.w|b``
    (stacked over that group's parts), ``latent`` (P, num_latent, D) and
    ``deformer.embed.dense|hash`` / ``deformer.mlp.<layer>.w|b``.

    Construction allocates uninitialised storage; use :func:`init_params`
    for a random model or ``load_state_dict(bridge.params_from_jax(...))``.
    """

    def __init__(self, spec: ModelSpec, device=None):
        super().__init__()
        P, E = spec.num_parts, spec.embed_dim
        self.embed = nn.ModuleDict({name: HashTables(spec.part_embeds[i], device)
                                    for i, name in enumerate(spec.partnames)})
        dh, nl = spec.occ_arch
        self.occ = make_mlp(E, 1 + spec.geo_feature_dim, dh, nl, P, device)
        rgb_in = (E + freq_out_dim(spec.viewdir_res) + spec.geo_feature_dim
                  + spec.latent_dim)
        self.rgb = nn.ModuleDict({
            f"h{dh_g}_l{nl_g}": make_mlp(rgb_in, 3, dh_g, nl_g, len(ids), device)
            for (dh_g, nl_g), ids in spec.rgb_groups()})
        self.latent = nn.Parameter(torch.empty(
            (P, spec.num_latent, spec.latent_dim), device=device))
        self.deformer = Deformer(spec.deformer, device)
        self.spec = spec


def init_params(spec: ModelSpec, generator: torch.Generator,
                device) -> InbModel:
    """A random model drawn from the JAX init's distributions (not its
    values: torch and jax random streams differ)."""
    model = InbModel(spec, device)
    for tables in model.embed.values():
        tables.reset_parameters(generator)
    for layers in [model.occ, *model.rgb.values(), model.deformer.mlp]:
        for layer in layers:
            layer.reset_parameters(generator)
    # occupancy-logit bias -3: start near-transparent (occ ~0.05)
    with torch.no_grad():
        model.occ[-1].b[:, 0] = -3.0
    kaiming_normal_(model.latent, generator)
    model.deformer.embed.reset_parameters(generator)
    return model


def _cast_tables(spec: ModelSpec, model: InbModel) -> List[dict]:
    """Part tables in the gather dtype (bf16 under the flagship config: half
    the gathered bytes; the lerp still accumulates in f32).  The deformer's
    tables stay f32."""
    dt = torch.bfloat16 if spec.grid_compute_dtype == "bfloat16" else None
    return [model.embed[n].tables(dt) for n in spec.partnames]


# --------------------------------------------------------------------------
# forward
# --------------------------------------------------------------------------

def resd_fn(spec: ModelSpec, model: InbModel, pts: torch.Tensor,
            batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Deformer residual at arbitrary canonical points (the pair
    regularizer's jittered neighbours)."""
    return deformer_apply(spec.deformer, model.deformer, pts, batch["tuv"],
                          batch["tbounds"], batch["frame_dim"],
                          tuv_sizes=batch.get("tuv_sizes"),
                          compute_dtype=spec.cdtype)


def forward(spec: ModelSpec, model: InbModel, wpts: torch.Tensor,
            viewdir: torch.Tensor, batch: Dict[str, torch.Tensor],
            train: bool = False) -> Dict[str, torch.Tensor]:
    """wpts/viewdir (N, 3) flattened ray samples -> dict with raw (N, 4),
    occ (N, 1) and the budget telemetry (cull/part overflow and need).
    ``train`` adds the selected points' residual ``resd`` (M, 3), bigpose
    points ``tpts`` (M, 3), occupancy ``tocc`` (M, 1), validity ``tflag``
    (M,), part ``tpart`` and part distance ``tdist`` (M,), part-major, the
    cull validity ``cull_valid`` (K,).

    ``batch`` carries the per-frame SMPL metadata: R (3,3), Th (1,3),
    A/big_A (24,4,4), pbw (X,Y,Z,25) + pbw_sizes + pbounds, part_pts /
    part_pbw / lengths2, part_bounds (P,2,3), tuv + tuv_sizes + tbounds,
    latent_index, frame_dim.
    """
    N = wpts.shape[0]
    P = spec.num_parts
    cd = spec.cdtype
    dev = wpts.device
    tables = _cast_tables(spec, model)

    # 1. world -> pose space
    pose_pts = lbs.world_points_to_pose_points(wpts, batch["R"], batch["Th"])
    pose_dirs = lbs.world_dirs_to_pose_dirs(viewdir, batch["R"])

    # 2. SMPL-distance cull on the pose volume's distance channel (only that
    #    channel is sampled; channels interpolate independently)
    pnorm = pts_sample_volume(pose_pts, batch["pbw"][..., -1:],
                              batch["pbounds"], sizes=batch.get("pbw_sizes"))[:, 0]
    K, Kps = budgets(spec, N)
    cidx, cvalid = topk_select(pnorm, K, spec.smpl_thresh)
    cpts = pose_pts[cidx].contiguous()                     # (K, 3)
    cdirs = pose_dirs[cidx]

    # 3. per-part KNN blend weights
    knn = knn_blend(cpts, batch["part_pts"], batch["part_pbw"],
                    batch["lengths2"], K=spec.knn_k, radius=spec.knn_radius,
                    chunk=spec.knn_chunk)                  # (K, P, 25)
    pred_pbw = knn[..., :lbs.NUM_BONES]
    part_dist = knn[..., lbs.NUM_BONES]                    # (K, P)
    pflag = (part_dist < spec.smpl_thresh) & cvalid[:, None]

    # 4. batched per-part selection into the (P, Kmax) padded layout:
    #    part p's budget Kp is the leading slice of one Kmax top-k
    Kmax = max(Kps)
    offs = np.cumsum((0,) + Kps)
    kp_arr = device_constant(("part_budgets", Kps), dev, lambda: np.asarray(Kps),
                             torch.int64)
    slots = arange(Kmax, dev)[None, :]
    score = torch.where(pflag, part_dist,
                        torch.full_like(part_dist, float("inf"))).T   # (P, K)
    best, idx_b = torch.topk(score, Kmax, dim=1, largest=False)       # (P, Kmax)
    valid_b = best < spec.smpl_thresh
    valid_pad = valid_b & (slots < kp_arr[:, None])

    all_idx = torch.cat([idx_b[p, :Kps[p]] for p in range(P)])        # (M,)
    all_valid = torch.cat([valid_b[p, :Kps[p]] for p in range(P)])
    pid = device_constant(("part_ids", Kps), dev,
                          lambda: np.repeat(np.arange(P), Kps), torch.int64)
    sel_pts = cpts[all_idx]
    sel_dirs = cdirs[all_idx]
    sel_bw = pred_pbw.reshape(K * P, lbs.NUM_BONES)[all_idx * P + pid]
    # invalid slots: all-zero blend weights would make A_bw singular
    sel_bw = torch.where(all_valid[:, None], sel_bw,
                         torch.full_like(sel_bw, 1.0 / lbs.NUM_BONES))

    # 5. inverse LBS pose -> tpose -> bigpose, once on the concatenation
    tmid = torch.mean(batch["tbounds"], dim=0)
    A1 = batch["A"][None]
    bigA1 = batch["big_A"][None]
    A_bw, R_inv = lbs.inverse_blend_params(sel_bw[None], A1)
    big_A_bw = lbs.blend_transforms(sel_bw[None], bigA1)
    init_tpose = lbs.pose_points_to_tpose_points(sel_pts[None], A_bw, R_inv)
    init_bigpose = lbs.tpose_points_to_pose_points(init_tpose, big_A_bw)[0]
    if spec.tpose_viewdir:
        init_tdirs = lbs.pose_dirs_to_tpose_dirs(sel_dirs[None], R_inv)
        all_dirs = lbs.tpose_dirs_to_pose_dirs(init_tdirs, big_A_bw)[0]
    else:
        all_dirs = sel_dirs
    init_bigpose = torch.where(all_valid[:, None], init_bigpose,
                               tmid.expand_as(init_bigpose))

    # 6. deformer residual on the concatenation
    all_resd = deformer_apply(spec.deformer, model.deformer, init_bigpose,
                              batch["tuv"], batch["tbounds"],
                              batch["frame_dim"], flag=all_valid,
                              tuv_sizes=batch.get("tuv_sizes"),
                              compute_dtype=cd)
    tpose = init_bigpose + all_resd                        # (M, 3)

    # 7. fused multi-part hash encoding
    emb = multi_hashgrid_encode(spec.part_embeds, tables, tpose,
                                batch["part_bounds"], Kps)  # (M, E)

    # 8. stacked-expert heads on the (P, Kmax) padded view
    def pad_parts(x):
        out = x.new_zeros((P, Kmax) + tuple(x.shape[1:]))
        for p in range(P):
            out[p, :Kps[p]] = x[offs[p]:offs[p + 1]]
        return out

    emb_pad = pad_parts(emb)
    hidden = mlp_apply_stacked(model.occ, emb_pad, cd)     # (P, Kmax, 1+geo)
    occ_v = 1.0 - torch.exp(-F.softplus(hidden[..., :1]))
    feature = hidden[..., 1:]

    dir_pad = pad_parts(freq_encode(all_dirs, spec.viewdir_res))
    latent = _latent_codes(model, batch["latent_index"])  # (P, D)
    latent = latent[:, None, :].expand(P, Kmax, spec.latent_dim)
    rgb_in = torch.cat([emb_pad, dir_pad, feature, latent], dim=-1)

    rgb_v = torch.zeros((P, Kmax, 3), dtype=torch.float32, device=dev)
    for (dh_g, nl_g), ids in spec.rgb_groups():
        sel = device_constant(("rgb_group", ids), dev, lambda: np.asarray(ids),
                              torch.int64)
        out = torch.sigmoid(mlp_apply_stacked(model.rgb[f"h{dh_g}_l{nl_g}"],
                                              rgb_in[sel], cd))
        rgb_v[sel] = out.float()
    raw_v = torch.cat([rgb_v, occ_v.float()], dim=-1)     # (P, Kmax, 4)

    # 9. one flat scatter back to the (K, P) per-part slots; invalid slots
    #    go to a spare row K*P that is cut off afterwards
    flat_idx = torch.where(valid_pad,
                           idx_b * P + arange(P, dev)[:, None],
                           torch.full_like(idx_b, K * P))
    raws = torch.zeros((K * P + 1, 4), dtype=torch.float32, device=dev)
    raws[flat_idx.reshape(-1)] = torch.where(
        valid_pad[..., None], raw_v, torch.zeros_like(raw_v)).reshape(-1, 4)
    raws = raws[:K * P].reshape(K, P, 4)
    occs = raws[..., 3:]                                   # (K, P, 1)

    # 10. aggregation across parts
    if spec.aggr == "mean":
        raw = torch.mean(raws, dim=1)
        occ = torch.mean(occs, dim=1)
    elif spec.aggr == "dist":
        inv = 1.0 / (part_dist + 1e-5)
        inv = inv / torch.clamp(torch.linalg.norm(inv, dim=-1, keepdim=True),
                                min=1e-12)
        raw = torch.sum(raws * inv[..., None], dim=1)
        occ = torch.sum(occs * inv[..., None], dim=1)
    else:  # default: the max-occupancy part wins the colour
        win = torch.argmax(occs[..., 0], dim=1)            # (K,)
        raw = torch.gather(raws, 1, win[:, None, None].expand(K, 1, 4))[:, 0]
        occ = torch.amax(occs, dim=1)

    # 11. scatter back to the full sample set
    raw_full = scatter_back(raw.new_zeros((N, 4)), cidx, raw, cvalid)
    occ_full = scatter_back(occ.new_zeros((N, 1)), cidx, occ, cvalid)

    # budget telemetry: overflow = share of threshold-passing points the
    # fixed budgets dropped; *_need = demand as a share of the budget
    true_surv = torch.sum(pnorm < spec.smpl_thresh)
    sel_surv = torch.sum(cvalid)
    flag_total = torch.sum(pflag)
    sel_total = torch.sum(all_valid)
    ret = {
        "raw": raw_full, "occ": occ_full,
        "cull_overflow": (true_surv - sel_surv) / torch.clamp(true_surv, min=1),
        "part_overflow": (flag_total - sel_total) / torch.clamp(flag_total, min=1),
        "cull_need": true_surv / N,
        "part_need": torch.sum(pflag, dim=0) / K,
    }
    if train:
        # the (M, 1) occupancies: a constant-index gather from (P, Kmax)
        tocc_idx = device_constant(
            ("tocc_idx", Kps), dev,
            lambda: np.concatenate([p * Kmax + np.arange(Kps[p]) for p in range(P)]),
            torch.int64)
        ret.update({
            "resd": all_resd,
            "tpts": init_bigpose,
            "tocc": occ_v.reshape(P * Kmax, 1)[tocc_idx],
            "tflag": all_valid,
            # each slot's part and part distance: the pair selection's
            # tie-break (renderer/inb_renderer.py:pair_order)
            "tpart": pid,
            "tdist": torch.cat([best[p, :Kps[p]] for p in range(P)]),
            "cull_valid": cvalid,
        })
    return ret


def _latent_codes(model: InbModel, index) -> torch.Tensor:
    """(P, D): every part's latent code of frame ``index``.  A tensor index
    is gathered on the device (indexing with a 0-d tensor would read it on
    the host, a wait that a CUDA graph cannot capture)."""
    if torch.is_tensor(index):
        return model.latent.index_select(1, index.reshape(1))[:, 0]
    return model.latent[:, index, :]


