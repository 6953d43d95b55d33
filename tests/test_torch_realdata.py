"""The port's real-subject path against the JAX package, on the CPU: dataset
items on a JPEG subject, dataset preparation, the reference ``.pth``
import, the bf16 first moment, ``sample_pdf`` and the trace summary.

Tolerances: dataset items bit-equal, key by key and dtype included (the
same harness as ``tests/test_torch_data.py``), under inb_377's deltas and
under inb_lan's (MonoCap); ``prepare_dataset``'s outputs bit-equal (its
rotations are ``image_ops.rodrigues``, bit-equal to ``cv2.Rodrigues``);
the imported state dict bit-equal to JAX's ``convert`` carried through
``bridge.params_from_jax``; the bf16-moment Adam within rtol 1e-6 / atol
1e-9 of optax ``adam(mu_dtype=bfloat16)`` over 5 steps (parameters, both
moments; the float32 pow of the bias correction and the order of the
update's products may differ in the last bit), its checkpoint resume bit-
equal; ``sample_pdf`` bit-equal to JAX's on the same draws with 31
weights a ray, within 1e-5 with 63 (XLA's row sum changes order).
"""
import os
import pickle
import sys
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from instant_nvr_tpu.config import make_cfg as jax_make_cfg
from instant_nvr_tpu.datasets import fake_zju as jfake
from instant_nvr_tpu.datasets.tpose_dataset import TPoseDataset as JaxDataset
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.ops import searchsorted as jsearch
from instant_nvr_tpu.train import state as jstate
from instant_nvr_tpu.train.stages import stage_for_epoch as jax_stage_for_epoch
from instant_nvr_tpu_torch import bridge, train_net
from instant_nvr_tpu_torch.config import Config, make_cfg
from instant_nvr_tpu_torch.datasets import fake_zju, image_ops
from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.ops import searchsorted
from instant_nvr_tpu_torch.tools import analyze_trace, import_torch_ckpt, make_fixtures
from instant_nvr_tpu_torch.tools import prepare_dataset
from instant_nvr_tpu_torch.train import checkpoint, loop
from instant_nvr_tpu_torch.train import state as tstate
from instant_nvr_tpu_torch.train.stages import stage_for_epoch
from test_torch_data import _assert_items_equal

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "tools"))
import import_torch_ckpt as jimport  # noqa: E402  (the JAX package's tool)
import make_fixtures as jmake_fixtures  # noqa: E402
import prepare_dataset as jprepare  # noqa: E402

CPU = torch.device("cpu")


# -- dataset items on a JPEG subject ---------------------------------------------

@pytest.fixture(scope="module")
def jpeg_subject(tmp_path_factory):
    """The port's fake subject with its images swapped for the committed
    JPEG fixtures; inb_lan's directory names link to the same files."""
    root = str(tmp_path_factory.mktemp("zju_jpeg"))
    fake_zju.write_jpeg_subject(root)
    for lan, ours in (("lbs", "smpl_lbs"), ("params", "smpl_params"),
                      ("vertices", "smpl_vertices")):
        os.symlink(ours, os.path.join(root, lan))
    return root


def _cfgs(root, yaml, **extra):
    n = fake_zju.JPEG_SUBJECT["n_frames"]
    cj = jax_make_cfg(os.path.join(ROOT, "configs", "inb", yaml))
    keep = {k: cj[k] for k in ("ratio",)}        # the config's own ratio
    cj = cj.merged(jfake.fake_cfg_overrides(root, n_frames=n)).merged(
        {"training_view": [0, 1], "test_view": [], "use_lpips": False,
         "patch_size": 16, "frame_interval": 1, **keep}).merged(extra)
    return cj, Config(cj.to_dict())


def test_jpeg_subject_reads_the_committed_jpegs(jpeg_subject):
    import imageio.v2 as imageio
    ann = np.load(os.path.join(jpeg_subject, "annots.npy"), allow_pickle=True).item()
    rels = [r for f in ann["ims"] for r in f["ims"]]
    assert len(rels) == 4 and all(r.endswith(".jpg") for r in rels)
    for rel in rels:
        path = os.path.join(jpeg_subject, rel)
        got = image_ops.read_image(path)
        assert got.shape == (256, 256, 3)
        np.testing.assert_array_equal(got, imageio.imread(path), err_msg=rel)


@pytest.mark.parametrize("yaml,stage,sampler", [
    ("inb_377.yaml", 0, "train"), ("inb_377.yaml", 2, "patch"),
    ("inb_lan.yaml", 0, "train"), ("inb_lan.yaml", 0, "patch")])
def test_items_match_jax_on_the_jpeg_subject(jpeg_subject, yaml, stage, sampler):
    """inb_377: ratio 0.3, then 0.5 with the head focus, edges eroded;
    inb_lan (MonoCap): ratio 1.0, no erosion, smpl_thresh 0.1, its own
    lbs/params/vertices directories."""
    cj, cp = _cfgs(jpeg_subject, yaml, use_lpips=sampler == "patch")
    cj, cp = jax_stage_for_epoch(cj, stage), stage_for_epoch(cp, stage)
    if yaml == "inb_lan.yaml":
        assert cp.ratio == 1.0 and not cp.erode_edge and cp.lbs == "lbs"
    jds, pds = JaxDataset(cj, "train"), TPoseDataset(cp, "train")
    assert len(jds) == len(pds) == 4
    for index in range(4):
        seed = np.random.SeedSequence(entropy=(11, stage, index))
        kw = {"ratio": cp.ratio, "sample_focus": cp.get("sample_focus", "")}
        want = jds.get_item(index, rng=np.random.default_rng(seed), **kw)
        got = pds.get_item(index, rng=np.random.default_rng(seed), **kw)
        _assert_items_equal(got, want, f"{yaml} item {index}")


def test_eval_items_match_jax_on_the_jpeg_subject(jpeg_subject):
    cj, cp = _cfgs(jpeg_subject, "inb_377.yaml")
    jds, pds = JaxDataset(cj, "test"), TPoseDataset(cp, "test")
    assert len(jds) == len(pds) >= 2
    for index in range(len(pds)):
        _assert_items_equal(pds.get_item(index), jds.get_item(index), f"item {index}")


# -- dataset preparation ---------------------------------------------------------

def _synthetic_smpl(tmp_path, n_verts=120, seed=0):
    """A small SMPL-like model pickle (sparse J_regressor included), two
    frames of params and vertices, and a UV .obj."""
    import scipy.sparse
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n_verts, 3)) * [0.2, 0.5, 0.1]
    faces = np.array([rng.choice(n_verts, 3, replace=False) for _ in range(2 * n_verts)])
    w = rng.random((n_verts, 24))
    w /= w.sum(1, keepdims=True)
    jreg = rng.random((24, n_verts)) * (rng.random((24, n_verts)) < 0.1)
    jreg /= np.maximum(jreg.sum(1, keepdims=True), 1e-9)
    parents = np.concatenate([[4294967295], np.maximum(np.arange(23) - 2, 0)])
    smpl = {"v_template": v, "shapedirs": rng.normal(size=(n_verts, 3, 10)) * 0.01,
            "J_regressor": scipy.sparse.csc_matrix(jreg), "weights": w,
            "kintree_table": np.stack([parents, np.arange(24)]).astype(np.int64),
            "f": faces.astype(np.uint32), "posedirs": np.zeros((n_verts, 3, 207))}
    pkl = str(tmp_path / "smpl.pkl")
    with open(pkl, "wb") as f:
        pickle.dump(smpl, f)
    root = tmp_path / "subject"
    for d in ("smpl_params", "smpl_vertices"):
        (root / d).mkdir(parents=True)
    for i in range(2):
        params = {"poses": rng.normal(size=(1, 72)) * 0.3, "Rh": rng.normal(size=(1, 3)),
                  "Th": rng.normal(size=(1, 3)), "shapes": rng.normal(size=(1, 10))}
        np.save(root / "smpl_params" / f"{i}.npy", params)
        np.save(root / "smpl_vertices" / f"{i}.npy", v + rng.normal(size=v.shape) * 0.01)
    obj = str(tmp_path / "uv.obj")
    with open(obj, "w") as f:
        for k in range(n_verts):
            f.write(f"v {v[k, 0]} {v[k, 1]} {v[k, 2]}\n")
        for k in range(n_verts):
            f.write(f"vt {rng.random():.6f} {rng.random():.6f}\n")
        for a, b, c in faces:
            f.write(f"f {a + 1}/{a + 1} {b + 1}/{b + 1} {c + 1}/{c + 1}\n")
    return str(root), pkl, obj


def _tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def test_prepare_dataset_matches_jax(tmp_path, monkeypatch, capsys):
    src, pkl, obj = _synthetic_smpl(tmp_path)
    outs = {}
    for name, run in (("jax", lambda a: jprepare.main()), ("port", prepare_dataset.main)):
        root = str(tmp_path / name)
        import shutil
        shutil.copytree(src, root)
        argv = ["--data_root", root, "--smpl_pkl", pkl, "--uv_obj", obj,
                "--frames", "0:2:1", "--voxel", "0.05"]
        monkeypatch.setattr(sys, "argv", ["prepare_dataset.py"] + argv)
        run(argv)
        outs[name] = root
    a, b = outs["port"], outs["jax"]
    files = _tree(a)
    assert files == _tree(b)
    assert {"smpl_lbs/bigpose_bw.npy", "smpl_lbs/bweights/1.npy", "bigpose_uv.npy",
            "smpl-meta/parents.npy"} <= set(files)
    for f in files:
        x, y = (np.load(os.path.join(r, f), allow_pickle=True) for r in (a, b))
        assert x.dtype == y.dtype and x.shape == y.shape, f
        if x.dtype == object:                      # the copied inputs
            x, y = x.item(), y.item()
            for k in x:
                np.testing.assert_array_equal(x[k], y[k], err_msg=f)
        else:
            np.testing.assert_array_equal(x, y, err_msg=f)
    vol = np.load(os.path.join(a, "smpl_lbs", "bweights", "0.npy"))
    assert np.isfinite(vol).all() and np.allclose(vol[..., :24].sum(-1), 1, atol=1e-5)


def test_make_fixtures_recipes_match_jax(monkeypatch):
    calls = {"port": [], "jax": []}
    monkeypatch.setattr(make_fixtures, "write_fake_dataset",
                        lambda *a, **k: calls["port"].append((a, k)))
    monkeypatch.setattr(jmake_fixtures, "write_fake_dataset",
                        lambda *a, **k: calls["jax"].append((a, k)))
    for only in ([], ["--only", "fake_zju5"], ["--only", "fake_zju_big"]):
        monkeypatch.setattr(sys, "argv", ["make_fixtures.py"] + only)
        jmake_fixtures.main()
        make_fixtures.main(only)
    assert calls["port"] == calls["jax"] and len(calls["port"]) == 4


# -- the reference checkpoint import ---------------------------------------------

# the tiny widths with two hashed levels per grid (at 4 levels every level
# of train_net.TINY is dense)
HASHED = {"partnet": {p: {"embedder": {"kwargs": {"n_levels": 6}}}
                      for p in ("body", "leg", "head", "larm", "rarm")},
          "tpose_deformer": {"embedder": {"kwargs": {"n_levels": 6}}}}


def _tiny_cfg():
    return make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(
        train_net.TINY).merged(HASHED)


def reference_state_dict(mspec, seed=0, drop=()):
    rng = np.random.default_rng(seed)
    return {"net." + k: torch.from_numpy(rng.normal(size=s).astype(np.float32))
            for k, s in import_torch_ckpt.reference_shapes(mspec).items() if k not in drop}


@pytest.mark.parametrize("drop", [(), ("tpose_human.part_networks.2.embedder.hash",
                                       "tpose_deformer.embedder.dense")])
def test_import_matches_jax_convert(drop):
    """JAX's convert -> params_from_jax equals the port's convert, every
    key bit for bit; a table the reference lacks keeps the initial one."""
    cfg = _tiny_cfg()
    mspec = inb.build_model_spec(cfg)
    jcfg = jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(
        train_net.TINY).merged(HASHED)
    jspec = jinb.build_model_spec(jcfg)
    params = jinb.init_params(jax.random.key(0), jspec)
    assert all(s.n_levels > s.start_hash for s in jspec.part_embeds)
    sd = reference_state_dict(mspec, drop=drop)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jimport.convert(sd, jspec, params)),
                                  mspec)
    base = bridge.params_from_jax(jax.tree.map(np.asarray, params), mspec)
    got = import_torch_ckpt.convert(sd, mspec, base)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert torch.equal(got[k], want[k]), k
    for k in drop:
        key = {"tpose_human.part_networks.2.embedder.hash": "embed.head.hash",
               "tpose_deformer.embedder.dense": "deformer.embed.dense"}[k]
        assert torch.equal(got[key], base[key])


def test_import_writes_a_checkpoint_load_weights_reads(tmp_path):
    cfg = _tiny_cfg()
    mspec = inb.build_model_spec(cfg)
    sd = reference_state_dict(mspec, seed=3)
    pth = str(tmp_path / "latest.pth")
    torch.save({"net": sd, "epoch": 7}, pth)
    out = str(tmp_path / "trained_model")
    import_torch_ckpt.import_checkpoint(cfg, import_torch_ckpt.load_reference(pth),
                                        out, 2, CPU)
    assert os.path.isfile(os.path.join(out, "2", "state.pt"))
    assert os.path.isfile(os.path.join(out, "latest", "state.pt"))
    model = inb.InbModel(mspec)
    checkpoint.load_weights(out, model, 2)
    want = import_torch_ckpt.convert(sd, mspec, inb.InbModel(mspec).state_dict())
    assert all(k[4:] in import_torch_ckpt.reference_shapes(mspec) for k in sd)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k
    payload = torch.load(os.path.join(out, "2", "state.pt"), weights_only=True)
    assert payload["step"] == 0 and payload["meta"]["epoch"] == 2
    assert payload["optimizer"]["state"] == {}           # a fresh Adam state


def test_import_refuses_shapes_that_do_not_fit(tmp_path):
    cfg = _tiny_cfg()
    mspec = inb.build_model_spec(cfg)
    base = inb.InbModel(mspec).state_dict()
    sd = reference_state_dict(mspec)
    key = "net.tpose_human.part_networks.1.occ.linears.0.weight"
    sd[key] = sd[key][:, :-1]
    with pytest.raises(ValueError, match="part_networks.1.occ.linears.0.weight"):
        import_torch_ckpt.convert(sd, mspec, base)
    sd = reference_state_dict(mspec)
    key = "net.tpose_human.part_networks.0.embedder.hash"
    sd[key] = sd[key][:, :-5]
    with pytest.raises(ValueError, match="part_networks.0.embedder.hash: shape"):
        import_torch_ckpt.convert(sd, mspec, base)


def test_import_cli_defaults_to_the_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cuda requested"):
        import_torch_ckpt.main(["--cfg_file", os.path.join(ROOT, "configs/inb/inb_377.yaml"),
                                "--ckpt", "x.pth", "--out", str(tmp_path)])


# -- the bf16 first moment -------------------------------------------------------

def _toy(rng):
    tree = {"embed": {"t": rng.normal(size=(257,)).astype(np.float32)},
            "mlp": {"w": rng.normal(size=(6, 5)).astype(np.float32),
                    "b": rng.normal(size=(5,)).astype(np.float32) * 1e-3}}

    def module(t):
        if isinstance(t, dict):
            m = torch.nn.Module()
            for k, v in t.items():
                setattr(m, k, module(v))
            return m
        return torch.nn.Parameter(torch.from_numpy(t.copy()))
    return tree, module(tree)


def _paths(tree, prefix=""):
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            yield from _paths(v, prefix + k + ".")
        else:
            yield prefix + k, v


@pytest.mark.parametrize("wd,mlp_scale", [(0.0, 1.0), (1e-3, 0.5)])
def test_bf16_moment_matches_optax(wd, mlp_scale):
    """5 steps of the same gradients through both packages' make_optimizer
    with ``train.moment_dtype: bfloat16``."""
    over = {"train": {"moment_dtype": "bfloat16", "weight_decay": wd, "lr": 1e-2},
            "mlp_weight_decay": mlp_scale}
    cfg_j = jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(over)
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(over)
    rng = np.random.default_rng(4)
    tree, model = _toy(rng)
    opt, _ = jstate.make_optimizer(cfg_j)
    params = jax.tree.map(jnp.asarray, tree)
    ost = opt.init(params)
    state = tstate.create_train_state(cfg, model)
    assert isinstance(state.optimizer, tstate.AdamBf16Mu)
    named = dict(model.named_parameters())
    for step in range(5):
        grads = jax.tree.map(lambda x: rng.normal(size=x.shape).astype(np.float32), tree)
        upd, ost = opt.update(jax.tree.map(jnp.asarray, grads), ost, params)
        params = optax.apply_updates(params, upd)
        for k, g in _paths(grads):
            named[k].grad = torch.from_numpy(g.copy())
        state.set_lr()
        state.optimizer.step()
        state.step += 1
        adam = [s for s in jax.tree.leaves(ost, is_leaf=lambda x: hasattr(x, "mu"))
                if hasattr(s, "mu")][0]
        mus, nus = dict(_paths(adam.mu)), dict(_paths(adam.nu))
        for k, want in _paths(params):
            p = named[k]
            st = state.optimizer.state[p]
            assert st["exp_avg"].dtype == torch.bfloat16 and mus[k].dtype == jnp.bfloat16
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(want), rtol=1e-6,
                                       atol=1e-9, err_msg=f"step {step} {k}")
            np.testing.assert_allclose(st["exp_avg"].float().numpy(),
                                       np.asarray(mus[k], np.float32), rtol=1e-6,
                                       atol=1e-9, err_msg=f"mu step {step} {k}")
            np.testing.assert_allclose(st["exp_avg_sq"].numpy(), np.asarray(nus[k]),
                                       rtol=1e-6, atol=1e-12, err_msg=f"nu step {step} {k}")


def test_bf16_moment_checkpoint_resumes_bit_equal(tmp_path):
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(
        {"train": {"moment_dtype": "bfloat16"}})
    grads = [_toy(np.random.default_rng(10 + i))[0] for i in range(5)]

    def run(steps, state):
        named = dict(state.model.named_parameters())
        for i in steps:
            for k, g in _paths(grads[i]):
                named[k].grad = torch.from_numpy(g.copy())
            state.set_lr()
            state.optimizer.step()
            state.step += 1

    whole = tstate.create_train_state(cfg, _toy(np.random.default_rng(1))[1])
    run(range(5), whole)
    first = tstate.create_train_state(cfg, _toy(np.random.default_rng(1))[1])
    run(range(2), first)
    checkpoint.save_checkpoint(str(tmp_path), 0, first, {"step": 2})
    resumed = tstate.create_train_state(cfg, _toy(np.random.default_rng(2))[1])
    checkpoint.load_checkpoint(str(tmp_path), resumed)
    assert resumed.step == 2
    for st in resumed.optimizer.state.values():
        assert st["exp_avg"].dtype == torch.bfloat16 and st["exp_avg_sq"].dtype == torch.float32
    run(range(2, 5), resumed)
    a, b = whole.optimizer.state_dict()["state"], resumed.optimizer.state_dict()["state"]
    for i in a:
        assert a[i]["step"] == b[i]["step"] == 5
        assert torch.equal(a[i]["exp_avg"], b[i]["exp_avg"])
        assert torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"])
    for (k, p), q in zip(whole.model.named_parameters(), resumed.model.parameters()):
        assert torch.equal(p, q), k


# -- sample_pdf ------------------------------------------------------------------

@pytest.mark.parametrize("R,S,n,det", [(64, 33, 24, False), (64, 33, 24, True),
                                         (128, 65, 64, False)])
def test_sample_pdf_matches_jax(R, S, n, det):
    """Bit-equal with 31 weights a row; with 63, XLA's row sum takes
    another order and the CDF moves in its last bits, so the samples are
    held to 1e-5 (random draws; a deterministic draw that sits on a CDF
    value could change bins there, so that case runs at 31 only)."""
    rng = np.random.default_rng(6)
    bins = np.sort(rng.random((R, S - 1)), -1).astype(np.float32)
    weights = (rng.random((R, S - 2)) * (rng.random((R, S - 2)) < 0.7)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jsearch.sample_pdf(key, jnp.asarray(bins), jnp.asarray(weights), n, det))
    u = None if det else torch.from_numpy(np.array(jax.random.uniform(key, (R, n))))
    got = searchsorted.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), n,
                                  det=det, u=u).numpy()
    if S <= 33:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    idx = searchsorted.searchsorted(torch.from_numpy(bins), torch.from_numpy(bins[:, ::3].copy()),
                                    side="left")
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jsearch.searchsorted(
        jnp.asarray(bins), jnp.asarray(bins[:, ::3]), side="left")))
    g = torch.Generator().manual_seed(0)
    drawn = searchsorted.sample_pdf(torch.from_numpy(bins), torch.from_numpy(weights), n,
                                    generator=g)
    assert drawn.shape == (R, n) and torch.isfinite(drawn).all()


# -- the trace summary -----------------------------------------------------------

def test_analyze_trace_on_a_cpu_trace(tmp_path, capsys):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        torch.randn(64, 64) @ torch.randn(64, 64)
    os.makedirs(tmp_path / "profile")
    prof.export_chrome_trace(str(tmp_path / "profile" / "trace.json"))
    res = analyze_trace.summarize(analyze_trace.find_trace(str(tmp_path)))
    assert res["busy"] is None and "no device events" in capsys.readouterr().out


def test_analyze_trace_buckets_and_busy_share_like_the_loop(tmp_path, capsys):
    """Device events of a CUDA trace, as torch.profiler names them: the
    union of their intervals equals loop._device_seconds on the same spans."""
    import json
    from torch.autograd import DeviceType
    ev = [("kernel", "void at::native::elementwise_kernel<128, 4>(int, float)", 0, 100),
          ("kernel", "void at::native::elementwise_kernel<128, 2>(int, double)", 150, 40),
          ("gpu_memcpy", "Memcpy HtoD (Pageable -> Device)", 20, 50),
          ("kernel", "knn_blend_kernel(float const*, int)", 400, 30),
          ("gpu_user_annotation", "ProfilerStep#3", 0, 1000),
          ("cpu_op", "aten::mul", 0, 1000)]
    trace = {"traceEvents": [{"ph": "X", "cat": c, "name": n, "ts": t, "dur": d}
                             for c, n, t, d in ev]}
    path = tmp_path / "t.json"
    path.write_text(json.dumps(trace))
    res = analyze_trace.summarize(str(path), 5)
    assert res["buckets"] == pytest.approx({"at::native::elementwise_kernel": 0.14,
                                            "Memcpy HtoD (Pageable -> Device)": 0.05,
                                            "knn_blend_kernel": 0.03})
    events = [SimpleNamespace(time_range=SimpleNamespace(start=t, end=t + d),
                              device_type=DeviceType.CUDA, is_user_annotation=False)
              for c, _, t, d in ev if c in analyze_trace.DEVICE_CATS]
    assert res["device_ms"] == pytest.approx(loop._device_seconds(events) * 1e3)
    assert res["busy"] == pytest.approx(res["device_ms"] / 1.0)
    assert "elementwise_kernel" in capsys.readouterr().out
