"""The port's evaluation and demo paths against the JAX package, on the CPU:
``run.py``'s evaluate / vis / bullet / dataset / network / export types, the
evaluator's branches, the persisted eval budgets, ``load_weights`` and the
camera orbit.

Both packages read the same tiny fake subject (2 frames x 2 views at 64^2,
written by the port; eval frames 32^2) through the same YAML config (the
tiny widths of ``tests/test_run_cli.py``, float32 MLPs and part tables).
The JAX side has no checkpoint, so its ``run.py`` keeps
``init_params(key(0))``; the port loads the same weights, carried across by
``bridge.params_from_jax``, from its own checkpoint.  Tolerances (float32):
per item PSNR within 1e-4 dB, SSIM and LPIPS within 1e-5 (measured: PSNR
and MSE equal, SSIM 4e-9, LPIPS 1e-9); the comparison PNGs, the orbit
frames and the eval budgets equal; the exports bit-equal.
"""
import glob
import io
import json
import os
import shutil
import subprocess
import sys
from contextlib import redirect_stdout

import cv2
import jax
import numpy as np
import pytest
import torch
import yaml

import run as jrun
from instant_nvr_tpu.config import Config as JConfig
from instant_nvr_tpu.config import make_cfg as jmake_cfg
from instant_nvr_tpu.datasets.fake_zju import fake_cfg_overrides
from instant_nvr_tpu.eval import evaluator as jevaluator
from instant_nvr_tpu.eval import runner as jrunner
from instant_nvr_tpu.eval import visualizer as jvis
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.renderer.inb_renderer import make_render_spec as jmrs
from instant_nvr_tpu_torch import bridge, run
from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
from instant_nvr_tpu_torch.eval import evaluator, runner, visualizer
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.ops import lbs
from instant_nvr_tpu_torch.renderer.inb_renderer import make_render_spec
from instant_nvr_tpu_torch.train import checkpoint
from instant_nvr_tpu_torch.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
TINY_EMBED = dict(n_levels=4, n_features_per_level=4, log2_hashmap_size=10,
                  base_resolution=4, b=1.38)


def tiny_overrides(root):
    """The tiny widths of tests/test_run_cli.py on the subject at ``root``."""
    return dict(fake_cfg_overrides(root, n_frames=2), **{
        "partnet": {p: {"embedder": {"kwargs": TINY_EMBED}} for p in
                    ("body", "leg", "head", "larm", "rarm")},
        "tpose_deformer": {"embedder": {"kwargs": dict(TINY_EMBED, sum=False)}},
        "network": {"occ": {"d_hidden": 32, "n_layers": 1},
                    "color": {"d_hidden": 32, "n_layers": 2}},
        "N_samples": 8, "N_rand": 128, "render_chunk": 512,
        "geo_feature_dim": 8, "latent_code_dim": 8, "num_latent_code": 2,
        "mlp_dtype": "float32", "grid_compute_dtype": "float32",
        "test": {"frame_sampler_interval": 1}, "render_views": 3,
        "exp_name": "eval"})


class Setup:
    """The subject, the YAML both packages load, the weights, and the
    port's checkpoint of them."""

    def __init__(self, base):
        self.root = os.path.join(base, "zju")
        write_fake_dataset(self.root, n_frames=2, n_views=2, H=64, W=64)
        self.yaml = os.path.join(base, "cfg.yaml")
        with open(self.yaml, "w") as f:
            yaml.safe_dump(tiny_overrides(self.root), f)
        self.ckpt = os.path.join(base, "model_t")
        cfg = self.port_cfg(os.path.join(base, "unused"))
        self.mspec_j = jinb.build_model_spec(JConfig(cfg.to_dict()))
        self.params_j = jinb.init_params(jax.random.key(0), self.mspec_j)
        mspec = inb.build_model_spec(cfg)
        model = inb.InbModel(mspec)
        model.load_state_dict(bridge.params_from_jax(
            jax.tree.map(np.asarray, self.params_j), mspec))
        checkpoint.save_checkpoint(self.ckpt, 0, create_train_state(cfg, model),
                                   {"step": 0, "epoch": 0})
        self.mspec, self.model = mspec, model

    def opts(self, exp, model_dir=None, **extra):
        out = ["result_dir", os.path.join(exp, "res"),
               "trained_model_dir", model_dir or os.path.join(exp, "model")]
        for k, v in extra.items():
            out += [k, str(v)]
        return out

    def jax_cfg(self, exp, **extra):
        return jmake_cfg(self.yaml, self.opts(exp, **extra))

    def port_cfg(self, exp, **extra):
        return make_cfg(self.yaml, self.opts(exp, **extra))

    def run_port(self, type_, exp, model_dir=None, **extra):
        """``python -m instant_nvr_tpu_torch.run --type type_`` on the CPU
        from a copy of the checkpoint (``exp/model_t`` unless ``model_dir``);
        returns its stdout."""
        model_dir = model_dir or os.path.join(exp, "model_t")
        if not os.path.isdir(model_dir):
            shutil.copytree(self.ckpt, model_dir)
        buf = io.StringIO()
        with redirect_stdout(buf):
            run.main(["--cfg_file", self.yaml, "--type", type_, "--device", "cpu"]
                     + self.opts(exp, model_dir=model_dir, **extra))
        return buf.getvalue()


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    return Setup(str(tmp_path_factory.mktemp("eval")))


def _pngs(d):
    return {os.path.basename(p): cv2.imread(p, cv2.IMREAD_UNCHANGED)
            for p in sorted(glob.glob(os.path.join(d, "*.png")))}


def _check_metrics(got, want):
    assert set(got) == set(want) == {"mse", "psnr", "ssim", "lpips"}
    assert len(got["psnr"]) == len(want["psnr"]) > 0
    np.testing.assert_allclose(got["mse"], want["mse"], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=0, atol=1e-5)


def _metrics(result_dir, name="metrics.npy"):
    return np.load(os.path.join(result_dir, name), allow_pickle=True).item()


# -- run --type evaluate | vis ---------------------------------------------------

@pytest.mark.parametrize("type_", ["evaluate", "vis"])
def test_run_evaluate_and_vis_match_jax(setup, tmp_path, type_):
    """metrics.npy per item, the comparison PNGs and eval_budgets.json, the
    budgets file read across packages, and a second evaluation that raises
    no budget.  ``vis`` writes the PNGs even under ``fast_eval``."""
    extra = {"fast_eval": True} if type_ == "vis" else {}
    cfg_j = setup.jax_cfg(str(tmp_path / "j"), **extra)
    getattr(jrun, f"run_{type_}")(cfg_j)
    out = setup.run_port(type_, str(tmp_path / "t"), **extra)
    assert "loaded weights from" in out and "budget overflow" in out
    cfg = setup.port_cfg(str(tmp_path / "t"))
    _check_metrics(_metrics(cfg.result_dir), _metrics(cfg_j.result_dir))
    got = _pngs(os.path.join(cfg.result_dir, "comparison"))
    want = _pngs(os.path.join(cfg_j.result_dir, "comparison"))
    assert sorted(got) == sorted(want) and len(got) == 6     # 2 items x 3 images
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)

    path_t = os.path.join(str(tmp_path / "t"), "model_t", "eval_budgets.json")
    path_j = runner.budgets_path(cfg_j)
    with open(path_t) as a, open(path_j) as b:
        saved_t, saved_j = json.load(a), json.load(b)
    assert saved_t == saved_j and set(saved_t) == {"cull_frac", "part_frac", "scales"}
    # each package starts from the other's file at the same budgets
    a = runner.AutoBudgetRenderer(setup.mspec, make_render_spec(cfg), 512,
                                  persist_path=path_j).mspec
    b = jrunner.AutoBudgetRenderer(setup.mspec_j, jmrs(cfg_j), 512,
                                   persist_path=path_t).mspec
    assert (a.cull_frac, a.part_frac, a.part_budget_scales) == \
        (b.cull_frac, b.part_frac, b.part_budget_scales)
    again = setup.run_port(type_, str(tmp_path / "t2"),
                           model_dir=os.path.dirname(path_t), **extra)
    assert "loaded raised budgets" in again and "budget overflow" not in again


def test_fast_eval_writes_metrics_without_images(setup, tmp_path):
    setup.run_port("evaluate", str(tmp_path), fast_eval=True)
    res = setup.port_cfg(str(tmp_path)).result_dir
    assert len(_metrics(res)["psnr"]) == 2
    assert not os.path.exists(os.path.join(res, "comparison"))


def test_evaluate_dataset_returns_timings_and_chunks(setup, tmp_path):
    cfg = setup.port_cfg(str(tmp_path)).replace(eval=True)
    r = runner.evaluate_dataset(cfg, setup.mspec, make_render_spec(cfg), setup.model,
                                max_items=1, save_images=False)
    (idx, rays, *secs), = r["items"]
    assert idx == 0 and rays > 0 and min(secs) >= 0
    # 1 render + 1 re-render after the budget raise, one chunk each
    assert r["chunks_rendered"] == 2 * runner.padded_chunks(rays, 512)
    assert np.isfinite([r[k] for k in ("mse", "psnr", "ssim", "lpips")]).all()


# -- the evaluator's branches ----------------------------------------------------

def _evaluator_inputs(rng, H=40, W=48):
    mask = np.zeros((H, W), bool)
    mask[5:31, 9:40] = rng.random((26, 31)) < 0.8
    n = int(mask.sum())
    gt = rng.random((n, 3)).astype(np.float32)
    pred = np.clip(gt + 0.1 * rng.normal(size=(n, 3)), 0, 1).astype(np.float32)
    sem = (rng.random((5, H, W)) < 0.5).astype(np.uint8)
    return pred, gt, mask.reshape(-1), H, W, sem


@pytest.mark.parametrize("branch", ["test_full", "masked", "eval_part"])
def test_evaluator_branches_match_jax(tmp_path, branch):
    """The same inputs through both evaluators: metrics, the PNGs (read back
    with cv2) and the summaries; the masked branch skips an all-zero GT."""
    rng = np.random.default_rng(3)
    pred, gt, mask, H, W, sem = _evaluator_inputs(rng)
    kw = dict(partnames=list(lbs.PARTNAMES), test_full=branch != "masked",
              eval_part="head" if branch == "eval_part" else "")
    ev_t = evaluator.Evaluator(str(tmp_path / "t"), **kw)
    ev_j = jevaluator.Evaluator(str(tmp_path / "j"), **kw)
    for ev in (ev_t, ev_j):
        ev.evaluate(pred, gt, mask, H, W, frame_index=1, view_index=2,
                    sem_mask=sem, epoch=4)
        ev.evaluate(pred, np.zeros_like(gt), mask, H, W, frame_index=2,
                    view_index=2, sem_mask=sem, epoch=4)
    got = {k: getattr(ev_t, k) for k in ("mse", "psnr", "ssim", "lpips")}
    want = {k: getattr(ev_j, k) for k in ("mse", "psnr", "ssim", "lpips")}
    assert len(got["psnr"]) == (1 if branch == "masked" else 2)
    # the all-zero GT item of the full branches has an infinite PSNR on
    # both sides (mse 0 only where pred is zero too): compare the first
    _check_metrics({k: v[:1] for k, v in got.items()}, {k: v[:1] for k, v in want.items()})
    assert ev_t.summarize(epoch=4).keys() == ev_j.summarize(epoch=4).keys()
    assert _metrics(str(tmp_path / "t"), "metrics_epoch4.npy").keys() == \
        _metrics(str(tmp_path / "j"), "metrics_epoch4.npy").keys()
    got = _pngs(str(tmp_path / "t" / "comparison_epoch4"))
    want = _pngs(str(tmp_path / "j" / "comparison_epoch4"))
    assert sorted(got) == sorted(want)
    assert len(got) == (0 if branch == "masked" else 6)
    for name in want:
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)


@pytest.mark.parametrize("case", ["block", "one_pixel", "full", "empty", "random"])
def test_bounding_rect_matches_cv2(case):
    rng = np.random.default_rng(5)
    m = np.zeros((33, 47), np.uint8)
    if case == "block":
        m[4:19, 30:41] = 1
    elif case == "one_pixel":
        m[32, 0] = 1
    elif case == "full":
        m[:] = 1
    elif case == "random":
        m = (rng.random(m.shape) < 0.01).astype(np.uint8)
    assert evaluator.bounding_rect(m) == tuple(cv2.boundingRect(m))
    if case == "empty":
        assert evaluator.bounding_rect(m) == (0, 0, 0, 0)


# -- bullet time -----------------------------------------------------------------

def test_run_bullet_matches_jax(setup, tmp_path):
    """Three orbit views with the body animating across the 2 frames; the
    frames equal JAX's (uint8); without ffmpeg the port keeps the PNGs and
    writes no video (JAX falls back to cv2's writer)."""
    cfg_j = setup.jax_cfg(str(tmp_path / "j"))
    jrun.run_bullet(cfg_j)
    out = setup.run_port("bullet", str(tmp_path / "t"))
    res = setup.port_cfg(str(tmp_path / "t")).result_dir
    got = _pngs(os.path.join(res, "novel_views"))
    want = _pngs(os.path.join(cfg_j.result_dir, "novel_views"))
    assert sorted(got) == sorted(want) == [f"frame_{i:04d}.png" for i in range(3)]
    for name in want:
        assert got[name].std() > 0
        np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    assert "(body frame 1)" in out
    if shutil.which("ffmpeg") is None:
        assert "no video" in out
        assert not os.path.exists(os.path.join(res, "novel_view.mp4"))


def test_merge_into_video_keeps_the_frames_without_ffmpeg(tmp_path, monkeypatch, capsys):
    from instant_nvr_tpu_torch.datasets.image_ops import write_png
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    for i in range(3):
        write_png(str(tmp_path / f"frame_{i:04d}.png"), np.full((8, 8, 3), 40 * i, np.uint8))
    out = str(tmp_path / "out.mp4")
    assert visualizer.merge_into_video(str(tmp_path), out) is False
    assert not os.path.exists(out) and "frames left in" in capsys.readouterr().out
    assert len(glob.glob(str(tmp_path / "frame_*.png"))) == 3


def test_camera_path_matches_jax():
    rng = np.random.default_rng(2)
    Rs = np.stack([cv2.Rodrigues(rng.normal(size=3) * 0.3)[0] for _ in range(4)])
    Ts = rng.normal(size=(4, 3, 1)) * 2.0
    center = rng.normal(size=3)
    for n in (1, 7):
        got = visualizer.gen_path_from_cams(Rs, Ts, center, n)
        want = jvis.gen_path_from_cams(Rs, Ts, center, n)
        for g, w in zip(got, want, strict=True):
            np.testing.assert_array_equal(g["R"], w["R"])
            np.testing.assert_array_equal(g["T"], w["T"])
    eye, up = np.array([1.0, 2.0, 3.0]), np.array([0.0, -1.0, 0.0])
    for g, w in zip(visualizer.look_at_pose(eye, center, up),
                    jvis.look_at_pose(eye, center, up)):
        np.testing.assert_array_equal(g, w)


# -- exports, dataset, network ---------------------------------------------------

@pytest.mark.parametrize("type_,sub", [("exportdecoder", "decoders"), ("exportpart", "parts")])
def test_exports_match_jax(setup, tmp_path, type_, sub):
    """The same npz files, key for key and bit for bit (at these widths the
    JAX tables carry no padding rows)."""
    cfg_j = setup.jax_cfg(str(tmp_path / "j"))
    getattr(jrun, f"run_{type_}")(cfg_j)
    setup.run_port(type_, str(tmp_path / "t"))
    res = setup.port_cfg(str(tmp_path / "t")).result_dir
    files = sorted(os.listdir(os.path.join(cfg_j.result_dir, sub)))
    assert files == sorted(os.listdir(os.path.join(res, sub))) and files
    for name in files:
        got = np.load(os.path.join(res, sub, name))
        want = np.load(os.path.join(cfg_j.result_dir, sub, name))
        assert sorted(got.files) == sorted(want.files), name
        for k in want.files:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{name}:{k}")


def test_run_dataset_matches_jax(setup, tmp_path, capsys):
    jrun.run_dataset(setup.jax_cfg(str(tmp_path)))
    want = [ln for ln in capsys.readouterr().out.splitlines() if ln.startswith("item ")]
    got = [ln for ln in setup.run_port("dataset", str(tmp_path)).splitlines()
           if ln.startswith("item ")]
    assert got == want and len(got) == 2            # 2 frames x training view 0


def test_run_network_times_a_dataset_batch_or_a_synthetic_one(setup, tmp_path):
    out = setup.run_port("network", str(tmp_path), N_rand=32)
    assert "timing a real dataset batch (32 rays)" in out and "forward:" in out
    out = setup.run_port("network", str(tmp_path), N_rand=32,
                         **{"train_dataset.data_root": str(tmp_path / "none"),
                            "train_dataset.ann_file": str(tmp_path / "none.npy")})
    assert "timing a synthetic batch" in out and "forward:" in out


def test_profile_eval_on_the_cpu(setup, tmp_path):
    """The tool's command line: one warm render profiled; on the CPU the
    trace holds no device time, which it says rather than inventing one."""
    from instant_nvr_tpu_torch.tools import profile_eval
    model_dir = str(tmp_path / "model_t")
    shutil.copytree(setup.ckpt, model_dir)
    buf = io.StringIO()
    with redirect_stdout(buf):
        profile_eval.main(["--cfg_file", setup.yaml, "--device", "cpu",
                           "--trace", str(tmp_path / "trace")]
                          + setup.opts(str(tmp_path), model_dir=model_dir))
    out = buf.getvalue()
    assert "loaded weights from" in out and "warm render:" in out
    assert "device: not measured, busy not measured" in out
    assert os.path.isfile(tmp_path / "trace" / "trace.json")
    assert os.path.isfile(os.path.join(model_dir, "eval_budgets.json"))


# -- weights ---------------------------------------------------------------------

def test_load_weights_selects_the_epoch(setup, tmp_path):
    cfg = setup.port_cfg(str(tmp_path))
    models = [run.build(cfg, CPU, seed=s)[2] for s in (1, 2, 3)]
    d = str(tmp_path / "ckpt")
    with pytest.raises(FileNotFoundError):
        checkpoint.load_weights(d, models[2])
    for epoch in (0, 1):
        checkpoint.save_checkpoint(d, epoch, create_train_state(cfg, models[epoch]),
                                   {"step": epoch, "epoch": epoch})

    def loaded(**kw):
        m = run.build(cfg, CPU, seed=9)[2]
        assert checkpoint.load_weights(d, m, **kw) is m
        return m.state_dict()

    def same(a, b):
        return all(torch.equal(a[k], b[k]) for k in a)
    want = [m.state_dict() for m in models]
    assert same(loaded(), want[1])                 # latest
    assert same(loaded(epoch=0), want[0])
    assert same(loaded(epoch=-1), want[1])
    shutil.rmtree(os.path.join(d, "latest"))
    assert same(loaded(epoch=7), want[1])          # the newest numbered epoch
    # --epoch reaches the loader through test.epoch
    buf = io.StringIO()
    with redirect_stdout(buf):
        run.main(["--cfg_file", setup.yaml, "--type", "exportdecoder", "--device", "cpu",
                  "--epoch", "0"] + setup.opts(str(tmp_path / "e"), model_dir=d))
    dec = np.load(os.path.join(setup.port_cfg(str(tmp_path / "e")).result_dir,
                               "decoders", "decoders.npz"))
    np.testing.assert_array_equal(dec["latent"], want[0]["latent"].numpy())


def test_missing_checkpoint_warns_like_jax(setup, tmp_path, capsys):
    jrun._load(setup.jax_cfg(str(tmp_path)))
    want = capsys.readouterr().out.strip().splitlines()[-1]
    mspec, _, model = run.load(setup.port_cfg(str(tmp_path)), CPU, seed=4)
    got = capsys.readouterr().out.strip().splitlines()[-1]
    assert got == want == "WARNING: no checkpoint found, using random init"
    ref = run.build(setup.port_cfg(str(tmp_path)), CPU, seed=4)[2].state_dict()
    assert all(torch.equal(v, ref[k]) for k, v in model.state_dict().items())


# -- imports ---------------------------------------------------------------------

GUARD = r"""
import sys
for name in ("cv2", "imageio", "PIL", "jax", "jaxlib"):
    sys.modules[name] = None            # any import of them raises ImportError
import instant_nvr_tpu_torch.run, instant_nvr_tpu_torch.train_net
import instant_nvr_tpu_torch.eval.evaluator, instant_nvr_tpu_torch.eval.runner
import instant_nvr_tpu_torch.eval.mesh, instant_nvr_tpu_torch.eval.visualizer
import instant_nvr_tpu_torch.train.loop, instant_nvr_tpu_torch.train.checkpoint
import instant_nvr_tpu_torch.tools.profile_eval
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("cv2", "imageio", "PIL", "jax", "jaxlib",
                                     "instant_nvr_tpu", "__graft_entry__"))
assert not bad, bad
print("ok")
"""


def test_eval_modules_import_without_jax_cv2_imageio_or_pil():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", GUARD], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"
