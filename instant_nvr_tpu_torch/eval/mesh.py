"""Canonical-pose mesh extraction (tmesh / tdmesh) and the geometry-pruning
cube (port of ``instant_nvr_tpu/eval/mesh.py``).

``occupancy_grid`` samples the part networks' occupancy on a grid over the
canonical box (after the UV-deformer residual for ``tdmesh``) on the
model's device, captured as a CUDA graph on the card (:class:`CapturedCube`,
the JAX package's jitted chunk); ``marching_tetrahedra`` (copied, numpy,
on the host as in JAX) extracts the
isosurface: each voxel splits into 6 tetrahedra, each tetrahedron gives 0-2
triangles with vertices interpolated on the crossing edges.  The cube is
also ``latest.npy``, the artifact ``prune_using_geo`` sampling reads.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

import numpy as np
import torch

from ..models.deformer import deformer_apply
from ..models.nn import mlp_apply_stacked
from ..ops.grid_sample import pts_sample_volume
from ..ops.hashgrid import hashgrid_encode
from ..train import compiled
from ..utils.constants import arange

# 6-tet decomposition of a cube (corner indices, bit order x*4+y*2+z)
_TETS = np.array([
    [0, 5, 1, 3], [0, 4, 5, 3], [4, 6, 5, 3],
    [5, 6, 7, 3], [0, 2, 3, 6], [0, 3, 4, 6],
])
_CUBE = np.array([[i >> 2 & 1, i >> 1 & 1, i & 1] for i in range(8)])

# points per occupancy call; the last chunk is padded with zeros
OCC_CHUNK = 65536
# the occupancy level of the extracted surface
ISO = 0.5
# the captured cubes kept at once: each holds its model and its graph's
# memory (the loop's per-epoch cube, prune's, tmesh's and tdmesh's)
MAX_CUBE_GRAPHS = 4


def marching_tetrahedra(grid: np.ndarray, iso: float
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """grid (X, Y, Z) scalar field -> (verts (V, 3) in index coords, faces)."""
    X, Y, Z = grid.shape
    # cube corner values for every voxel: (X-1, Y-1, Z-1, 8)
    vals = np.empty((X - 1, Y - 1, Z - 1, 8), grid.dtype)
    for c, (dx, dy, dz) in enumerate(_CUBE):
        vals[..., c] = grid[dx:X - 1 + dx, dy:Y - 1 + dy, dz:Z - 1 + dz]

    base = np.stack(np.meshgrid(np.arange(X - 1), np.arange(Y - 1),
                                np.arange(Z - 1), indexing="ij"), -1)  # (...,3)

    verts_out = []
    faces_out = []
    n_verts = 0
    for tet in _TETS:
        tv = vals[..., tet]                          # (..., 4)
        inside = tv > iso                            # (..., 4)
        code = (inside * np.array([1, 2, 4, 8])).sum(-1)
        corners = _CUBE[tet]                         # (4, 3)

        # case -> list of triangles, each triangle = 3 edges (pairs of tet verts)
        def tris_for(code_val):
            ins = [i for i in range(4) if code_val >> i & 1]
            outs = [i for i in range(4) if not code_val >> i & 1]
            if len(ins) == 0 or len(ins) == 4:
                return []
            if len(ins) == 1:
                a = ins[0]
                e = [(a, outs[0]), (a, outs[1]), (a, outs[2])]
                return [e]
            if len(ins) == 3:
                a = outs[0]
                e = [(a, ins[0]), (a, ins[1]), (a, ins[2])]
                return [e]
            # 2 in, 2 out -> quad -> 2 triangles
            a, b = ins
            c, d = outs
            e1, e2, e3, e4 = (a, c), (a, d), (b, d), (b, c)
            return [[e1, e2, e3], [e1, e3, e4]]

        for code_val in range(1, 15):
            mask = code == code_val
            if not mask.any():
                continue
            cells = base[mask]                       # (M, 3)
            cvals = tv[mask]                         # (M, 4)
            for tri in tris_for(code_val):
                tri_pts = []
                for (i, j) in tri:
                    vi, vj = cvals[:, i], cvals[:, j]
                    t = (iso - vi) / np.where(np.abs(vj - vi) < 1e-12, 1e-12,
                                              vj - vi)
                    t = np.clip(t, 0.0, 1.0)[:, None]
                    pi = cells + corners[i]
                    pj = cells + corners[j]
                    tri_pts.append(pi + t * (pj - pi))
                m = len(cells)
                verts_out.extend(tri_pts)
                idx = n_verts + np.arange(m)
                faces_out.append(np.stack([idx, idx + m, idx + 2 * m], -1))
                n_verts += 3 * m

    if not verts_out:
        return np.zeros((0, 3)), np.zeros((0, 3), np.int64)
    verts = np.concatenate(verts_out, axis=0)
    faces = np.concatenate(faces_out, axis=0)
    return verts, faces


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]:.6f} {v[1]:.6f} {v[2]:.6f}\n")
        for tri in faces + 1:
            f.write(f"f {tri[0]} {tri[1]} {tri[2]}\n")


def grid_axes(tbounds: np.ndarray, res: int) -> np.ndarray:
    """The cube's three axes (3, res) over the box ``tbounds`` (2, 3):
    ``np.linspace`` in float32, as the JAX package makes them."""
    tb = np.asarray(tbounds)
    return np.stack([np.linspace(tb[0, d], tb[1, d], res, dtype=np.float32)
                     for d in range(3)])


def grid_points(axes: torch.Tensor, start: int, count: int) -> torch.Tensor:
    """Points ``start .. start + count - 1`` of the res^3 grid over
    ``axes`` (3, res), in ``np.meshgrid(*axes, indexing='ij')`` order,
    gathered on ``axes``' device (so bit for bit the host grid's floats);
    points past the grid are zeros (the padding of the last chunk)."""
    res = axes.shape[1]
    idx = arange(count, axes.device) + start
    inside = idx < res ** 3
    idx = torch.where(inside, idx, torch.zeros_like(idx))
    ijk = (idx // (res * res), idx // res % res, idx % res)
    pts = torch.stack([axes[d].index_select(0, ijk[d]) for d in range(3)], -1)
    return torch.where(inside[:, None], pts, torch.zeros_like(pts))


def cube_inputs(cfg, batch_meta: Dict, res: int, device
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor], float]:
    """The cube's inputs on ``device``: the axes (3, res), the meta
    (``tuv``, ``tbounds``, ``frame_dim``, ``part_bounds``, and ``tbw`` when
    the frame has its 4-D volume) and the SMPL-distance threshold."""
    t = lambda a: torch.as_tensor(np.asarray(a), device=device)
    tb = np.asarray(batch_meta["tbounds"])
    meta = {"tuv": t(batch_meta["tuv"]), "tbounds": t(tb),
            "frame_dim": torch.tensor(float(batch_meta.get("frame_dim", 0.0)),
                                      dtype=torch.float32, device=device),
            "part_bounds": t(batch_meta["part_bounds"])}
    tbw = batch_meta.get("tbw")
    if tbw is not None and np.asarray(tbw).ndim == 4:
        meta["tbw"] = t(tbw)
    mesh_thresh = 2.0 * float(cfg.get("smpl_thresh", 0.05)) if cfg else 0.1
    return t(grid_axes(tb, res)), meta, mesh_thresh


def _cube(mspec, model, axes: torch.Tensor, meta: Dict[str, torch.Tensor],
          deformed: bool, mesh_thresh: float, chunk: int) -> torch.Tensor:
    """The occupancy of every grid point over ``axes``, chunk by chunk into
    one device tensor (the grid padded to a whole chunk): no host value
    changes from call to call, so a CUDA graph of it replays."""
    n = axes.shape[1] ** 3
    out = torch.empty(-(-n // chunk) * chunk, dtype=torch.float32, device=axes.device)
    part_bounds, tbounds = meta["part_bounds"], meta["tbounds"]
    tbw = meta.get("tbw")
    tables = [model.embed[name].tables() for name in mspec.partnames]
    for i in range(0, out.shape[0], chunk):
        x = grid_points(axes, i, chunk)
        if deformed:
            x = x + deformer_apply(mspec.deformer, model.deformer, x, meta["tuv"],
                                   tbounds, meta["frame_dim"])
        emb = torch.stack([hashgrid_encode(mspec.part_embeds[p], tables[p], x,
                                           part_bounds[p])
                           for p in range(mspec.num_parts)])       # (P, N, E)
        h = mlp_apply_stacked(model.occ, emb)                      # (P, N, 1+geo)
        o = 1.0 - torch.exp(-torch.nn.functional.softplus(h[..., 0]))
        inside = torch.all((x[None] >= part_bounds[:, None, 0])
                           & (x[None] <= part_bounds[:, None, 1]), -1)
        occ = torch.amax(torch.where(inside, o, torch.zeros_like(o)), dim=0)
        if tbw is not None:
            dist = pts_sample_volume(x, tbw, tbounds)[:, -1]
            occ = torch.where(dist < mesh_thresh, occ, torch.zeros_like(occ))
        out[i:i + chunk] = occ
    return out


def cube_route(device, eager: bool = False) -> compiled.Route:
    """The occupancy cube's route: ``captured`` (:class:`CapturedCube`) on a
    CUDA device unless ``eager``; ``eager`` with its reason otherwise."""
    return compiled.program_route(device, eager)


class CapturedCube(compiled.CapturedProgram):
    """:func:`_cube` as CUDA graphs, the port's counterpart of the JAX
    package's jitted ``occ_chunk``: one graph per static key, ``(id(model),
    the spec, res, deformed, the SMPL-distance threshold, the chunk, the
    meta's keys, shapes and dtypes)`` (``tbw`` is in the meta when the
    frame has its volume).  The axes and the meta (``tuv``, ``tbounds``,
    ``frame_dim``, ``part_bounds``, ``tbw``) are static inputs, filled on
    each call; the weights are read by address, and the optimizer and
    ``load_state_dict`` write them in place, so a replay sees the weights
    of the moment.  The first call of a key runs eagerly on the side
    stream (the warm-up), the second captures every chunk into one graph,
    and each call replays it (:class:`~..train.compiled.CapturedProgram`);
    the ``MAX_CUBE_GRAPHS`` keys used last keep their graphs (and models).
    Refuses a model off the card."""

    name = "cube"

    def __init__(self):
        super().__init__(max_graphs=MAX_CUBE_GRAPHS)

    def __call__(self, mspec, model, axes: torch.Tensor, meta: Dict[str, torch.Tensor],
                 deformed: bool, mesh_thresh: float, chunk: int) -> torch.Tensor:
        device = next(model.parameters()).device
        if device.type != "cuda":
            raise RuntimeError(f"a captured cube runs on a CUDA device, not {device}; "
                               f"eager=True runs it on the CPU")
        key = (id(model), mspec, axes.shape[1], deformed, mesh_thresh, chunk,
               compiled.signature(meta))
        return self.run(key, {"axes": {"axes": axes}, "meta": meta}, device,
                        lambda st: {"occ": _cube(mspec, model, st["axes"]["axes"],
                                                 st["meta"], deformed, mesh_thresh,
                                                 chunk)},
                        holds=model)["occ"]


# the cubes of this process (the loop's one a run, prune's, tmesh's), as
# the JAX package keeps its jitted programs
CUBES = CapturedCube()


@torch.no_grad()
def occupancy_grid(cfg, mspec, model, batch_meta: Dict, deformed: bool,
                   res: int = 128, eager: bool = False) -> Tuple[np.ndarray, np.ndarray]:
    """Aggregated part occupancy on a res^3 grid over the canonical box, in
    float32 on the model's device -> (occupancy (res, res, res), tbounds).

    Per point: the deformer residual (``deformed``), each part's hash
    encoding and occupancy MLP, zero outside the part's box, the max over
    parts; with a canonical blend-weight volume (``tbw`` 4-D) zero where the
    SMPL distance is not below 2 x ``smpl_thresh``, as the render path
    culls (training never supervises points far from the surface).

    The points are made on the device from the three axes (:func:`
    grid_points`), and the cube comes back in one copy.  On
    :func:`cube_route`'s route: captured (:data:`CUBES`) on the card
    unless ``eager``."""
    device = next(model.parameters()).device
    axes, meta, mesh_thresh = cube_inputs(cfg, batch_meta, res, device)
    args = (mspec, model, axes, meta, deformed, mesh_thresh, OCC_CHUNK)
    route = cube_route(device, eager)
    print(f"cube route: {route}", flush=True)
    occ = CUBES(*args) if route.name == "captured" else _cube(*args)
    return occ[:res ** 3].cpu().numpy().reshape(res, res, res), \
        np.asarray(batch_meta["tbounds"])


def extract_mesh(cfg, mspec, model, out_dir: str, deformed: bool = False,
                 res: int = 128, eager: bool = False):
    """Occupancy cube of the test split's first item -> ``out_dir``'s
    ``latest.npy`` and ``mesh.obj`` (the ``ISO`` surface, vertices in canonical
    coordinates); the cube on :func:`cube_route`'s route."""
    from ..datasets.tpose_dataset import TPoseDataset
    os.makedirs(out_dir, exist_ok=True)
    item = TPoseDataset(cfg, "test").get_item(0)
    occ, tb = occupancy_grid(cfg, mspec, model, item, deformed, res, eager=eager)
    np.save(os.path.join(out_dir, "latest.npy"), occ)
    verts, faces = marching_tetrahedra(occ, ISO)
    verts = tb[0] + verts / (res - 1) * (tb[1] - tb[0])
    path = os.path.join(out_dir, "mesh.obj")
    write_obj(path, verts, faces)
    print(f"wrote {path}: {len(verts)} verts, {len(faces)} faces")
    return verts, faces
