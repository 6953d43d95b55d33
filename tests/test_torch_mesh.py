"""The port's occupancy cube and mesh extraction against the JAX package, on
the CPU: ``occupancy_grid`` (with and without the deformer residual and the
SMPL-distance cull of a 4-D ``tbw``), ``marching_tetrahedra`` and
``write_obj`` (copied: bit-equal), ``extract_mesh``, and ``run.py --type
prune | tmesh | tdmesh`` (their cubes at res 24).

Same subject, config and weights as tests/test_torch_eval.py (float32).
Tolerance of the cubes: atol 1e-5 (measured: 6e-8; the same float32 ops,
with the MLP's and the trilinear sums in other orders); a mesh's faces
equal and its vertices within 1e-5.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import run as jrun
from instant_nvr_tpu.eval import mesh as jmesh
from instant_nvr_tpu_torch import bridge
from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
from instant_nvr_tpu_torch.eval import mesh
from instant_nvr_tpu_torch.models import inb
from test_torch_eval import Setup

ATOL = 1e-5


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return Setup(str(tmp_path_factory.mktemp("mesh")))


@pytest.fixture(scope="module")
def item(setup):
    return TPoseDataset(setup.port_cfg(setup.ckpt), "test").get_item(0)


def _read_obj(path):
    v, f = [], []
    with open(path) as fh:
        for ln in fh:
            kind, *rest = ln.split()
            (v if kind == "v" else f).append([float(x) if kind == "v" else int(x)
                                              for x in rest])
    return np.array(v).reshape(-1, 3), np.array(f, np.int64).reshape(-1, 3)


@pytest.mark.parametrize("deformed", [False, True], ids=["tmesh", "tdmesh"])
@pytest.mark.parametrize("tbw", [True, False], ids=["tbw", "no_tbw"])
def test_occupancy_grid_matches_jax(setup, item, deformed, tbw):
    meta = dict(item) if tbw else {k: v for k, v in item.items() if k != "tbw"}
    assert np.asarray(item["tbw"]).ndim == 4
    cfg = setup.port_cfg(setup.ckpt)
    want, tb_j = jmesh.occupancy_grid(cfg, setup.mspec_j, setup.params_j, meta,
                                      deformed, res=24)
    got, tb = mesh.occupancy_grid(cfg, setup.mspec, setup.model, meta, deformed,
                                  res=24)
    assert got.shape == (24, 24, 24) and got.dtype == np.float32
    np.testing.assert_array_equal(tb, tb_j)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    assert got.std() > 0 and (got == 0).any() == tbw      # the SMPL-distance cull


def test_marching_tetrahedra_and_write_obj_are_bit_equal(tmp_path):
    rng = np.random.default_rng(0)
    x = np.linspace(-1, 1, 14)
    grid = (np.sqrt(sum(g ** 2 for g in np.meshgrid(x, x, x, indexing="ij")))
            + 0.1 * rng.normal(size=(14, 14, 14))).astype(np.float32)
    for iso in (0.6, 5.0):                              # a surface; none
        got, want = mesh.marching_tetrahedra(grid, iso), jmesh.marching_tetrahedra(grid, iso)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        mesh.write_obj(str(tmp_path / "t.obj"), *got)
        jmesh.write_obj(str(tmp_path / "j.obj"), *want)
        assert (tmp_path / "t.obj").read_bytes() == (tmp_path / "j.obj").read_bytes()
    assert len(mesh.marching_tetrahedra(grid, 0.6)[1]) > 100


@pytest.fixture(scope="module")
def steep(setup):
    """The weights with the occupancy logit scaled by 300 (and its bias
    zeroed), on both sides: an occupancy that crosses 0.5 steeply, so a
    vertex's place on its edge is well conditioned (the random model's
    occupancy stays within 0.06 +- 0.001, where a 1e-7 difference in the
    cube moves a vertex by 1e-4)."""
    params = jax.tree.map(np.array, setup.params_j)
    last = params["occ"][-1]
    last["w"][..., 0] *= 300.0
    last["b"][..., 0] = 0.0
    model = inb.InbModel(setup.mspec)
    model.load_state_dict(bridge.params_from_jax(params, setup.mspec))
    return jax.tree.map(jnp.asarray, params), model


@pytest.mark.parametrize("deformed", [False, True], ids=["tmesh", "tdmesh"])
def test_extract_mesh_matches_jax(setup, steep, tmp_path, deformed):
    """``latest.npy`` and ``mesh.obj`` at res 24 and iso 0.5."""
    cfg = setup.port_cfg(setup.ckpt)
    params_j, model = steep
    got = mesh.extract_mesh(cfg, setup.mspec, model, str(tmp_path / "t"),
                            deformed, res=24)
    want = jmesh.extract_mesh(cfg, setup.mspec_j, params_j, str(tmp_path / "j"),
                              deformed, res=24)
    assert len(got[1]) > 100
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=ATOL)
    np.testing.assert_allclose(np.load(tmp_path / "t" / "latest.npy"),
                               np.load(tmp_path / "j" / "latest.npy"), rtol=0, atol=ATOL)
    vt, ft = _read_obj(tmp_path / "t" / "mesh.obj")
    vj, fj = _read_obj(tmp_path / "j" / "mesh.obj")
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(vt, vj, rtol=0, atol=ATOL)


def small_cubes(monkeypatch, res=24):
    """Both packages' ``occupancy_grid`` at ``res`` in place of the 128 that
    ``run.py``'s types ask for (2.1 M points take minutes on a loaded CPU;
    the card runs them at 128 in ``chip_smoke.py`` phase 9)."""
    for mod in (jmesh, mesh):
        orig = mod.occupancy_grid
        monkeypatch.setattr(mod, "occupancy_grid",
                            lambda cfg, mspec, params, meta, deformed, *_, _orig=orig,
                            **__: _orig(cfg, mspec, params, meta, deformed, res=res))


@pytest.mark.parametrize("type_", ["prune", "tmesh", "tdmesh"])
def test_run_mesh_types_match_jax(setup, tmp_path, type_, monkeypatch):
    """``run --type prune | tmesh | tdmesh`` against the JAX ``run.py``'s
    (cubes at res 24): the cube, and the mesh (empty at iso 0.5 for the
    random model, as on the JAX side)."""
    small_cubes(monkeypatch)
    cfg_j = setup.jax_cfg(str(tmp_path / "j"))
    if type_ == "prune":
        jrun.run_prune(cfg_j)
    else:
        jrun.run_tmesh(cfg_j, deformed=type_ == "tdmesh")
    out = setup.run_port(type_, str(tmp_path / "t"))
    assert "loaded weights from" in out
    sub = "" if type_ == "prune" else type_
    res = setup.port_cfg(str(tmp_path / "t")).result_dir
    got = np.load(os.path.join(res, sub, "latest.npy"))
    want = np.load(os.path.join(cfg_j.result_dir, sub, "latest.npy"))
    assert got.shape == (24, 24, 24) and np.isfinite(got).all()
    assert 0.0 <= got.min() and got.max() <= 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    if type_ != "prune":
        vt, ft = _read_obj(os.path.join(res, sub, "mesh.obj"))
        vj, fj = _read_obj(os.path.join(cfg_j.result_dir, sub, "mesh.obj"))
        np.testing.assert_array_equal(ft, fj)
        np.testing.assert_allclose(vt, vj, rtol=0, atol=ATOL)


def test_occupancy_grid_pads_the_last_chunk(setup, item, monkeypatch):
    """A grid that is not a multiple of the chunk: the zero-padded tail is
    cut off, and the values do not depend on the chunking."""
    cfg = setup.port_cfg(setup.ckpt)
    whole, _ = mesh.occupancy_grid(cfg, setup.mspec, setup.model, item, False, res=11)
    monkeypatch.setattr(mesh, "OCC_CHUNK", 500)
    parts, _ = mesh.occupancy_grid(cfg, setup.mspec, setup.model, item, False, res=11)
    np.testing.assert_array_equal(whole, parts)
    assert torch.is_grad_enabled()
