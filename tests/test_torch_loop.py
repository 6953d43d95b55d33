"""The port's training loop on the CPU: the device batch and its cache,
epochs and stages over the prefetcher, checkpoint and resume, the profiler
window, the eval cadence (validation, visualization, the pruning cube)
against the JAX loop's calls, the command line, and a run with cv2,
imageio, PIL and jax blocked.

The loop runs at the tiny widths (``train_net.TINY``) on a fake subject of
2 frames x 2 views at 96^2, written by the port.  A run resumed from its
checkpoint must end bit-equal to the same run unbroken: the items are
seeded by (epoch, position) and the step's draws by the global step.
"""
import glob
import io
import os
import subprocess
import sys
from contextlib import redirect_stdout

import cv2
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from instant_nvr_tpu.config import Config as JConfig
from instant_nvr_tpu.eval import mesh as jmesh
from instant_nvr_tpu.eval import runner as jrunner
from instant_nvr_tpu.models import inb as jinb
from instant_nvr_tpu.renderer import inb_renderer as jrend
from instant_nvr_tpu.train import loop as jloop
from instant_nvr_tpu.train import recorder as jrecorder
from instant_nvr_tpu_torch import bridge, train_net
from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.train import checkpoint, loop, recorder
from instant_nvr_tpu_torch.train.state import create_train_state

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")
F32_MODE = {"mlp_dtype": "float32", "grid_compute_dtype": "float32"}


@pytest.fixture(scope="module")
def subject(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("zju_loop"))
    write_fake_dataset(root, n_frames=2, n_views=2, H=96, W=96)
    return root


def _cfg(root, exp, **extra):
    """inb_fake at the tiny widths in patch mode (8x8 patches), 2 steps an
    epoch, inb_377's two ratio stages on epochs 0 and 1."""
    data = {"data_root": root, "ann_file": os.path.join(root, "annots.npy")}
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_fake.yaml"))
    finally:
        os.chdir(cwd)
    cfg = cfg.merged(train_net.TINY).merged({
        "train_dataset": data, "val_dataset": data, "test_dataset": data,
        "smpl_meta": os.path.join(root, "smpl-meta"), "num_train_frame": 2,
        "training_view": [0, 1], "test_view": [],
        "use_lpips": True, "patch_size": 8, "ep_iter": 2, "train": {"epoch": 2},
        "save_latest_ep": 1, "log_interval": 1,
        "training_stages": [{"ratio": 0.3, "_start": 0},
                            {"ratio": 0.5, "sample_focus": "head", "_start": 1}],
        "result_dir": os.path.join(exp, "res"),
        "trained_model_dir": os.path.join(exp, "model"),
        "record_dir": os.path.join(exp, "record")})
    return cfg.merged(extra)


def _params(state):
    return {k: v.detach().clone() for k, v in state.model.state_dict().items()}


# -- the device batch ------------------------------------------------------------

def test_device_batch_matches_jax_and_keeps_an_lru_of_frames(monkeypatch):
    monkeypatch.setattr(loop, "MAX_CACHED_FRAMES", 2)
    rng = np.random.default_rng(0)

    def item(frame):
        it = {k: rng.random((3, 2)).astype(np.float32) for k in loop.DEVICE_KEYS
              if k != "reg_dist_weight"}
        it.update(frame_index=np.int32(frame), coord=np.zeros((3, 2), np.int64))
        return it
    cache, jcache = {}, {}
    put = lambda v: torch.as_tensor(np.asarray(v))
    for frame in (0, 1, 0, 2):
        it = item(frame)
        got = loop.device_batch(it, 0.25, put, cache=cache)
        want = jloop.device_batch(it, 0.25, cache=jcache, max_cached_frames=2)
        assert set(got) == set(want) == set(loop.DEVICE_KEYS)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert loop.DEVICE_KEYS == jloop.DEVICE_KEYS
    assert loop.FRAME_KEYS == jloop.FRAME_KEYS and loop.STATIC_KEYS == jloop.STATIC_KEYS
    assert set(cache) == set(jcache) and cache["_frames"] == [0, 2]
    # a cached frame's tensors are the ones first put, static keys once
    again = loop.device_batch(item(2), 0.25, put, cache=cache)
    assert again["A"] is cache[("A", 2)] and again["tuv"] is cache[("tuv",)]
    assert again["rgb"] is not cache.get(("rgb",))


# -- the loop --------------------------------------------------------------------

def test_loop_trains_saves_and_resumes(subject, tmp_path):
    """2 epochs x 2 patch steps with a checkpoint each epoch, then a resume
    for a third epoch; the resumed run ends where the unbroken one does."""
    cfg = _cfg(subject, str(tmp_path / "a"))
    res = loop.train(cfg, CPU, resume=False)
    assert res.state.step == 4 and len(res.losses) == 4
    assert np.isfinite(res.losses).all()
    assert [(e.epoch, e.steps) for e in res.epochs] == [(0, 2), (1, 2)]
    assert all(0 <= e.data_s <= e.wall_s for e in res.epochs)
    for tag in ("0", "1", "latest"):
        assert os.path.isfile(os.path.join(cfg.trained_model_dir, tag, checkpoint.STATE_FILE))
    assert os.path.isfile(os.path.join(cfg.result_dir, "config.yaml"))
    # every epoch done: a resume returns the restored state, no step taken
    done = loop.train(cfg, CPU, resume=True)
    assert done.state.step == 4 and done.losses == [] and done.epochs == []
    saved = _params(res.state)
    for k, v in _params(done.state).items():
        assert torch.equal(v, saved[k]), k

    resumed = loop.train(cfg.merged({"train": {"epoch": 3}}), CPU, resume=True)
    assert resumed.state.step == 6 and [e.epoch for e in resumed.epochs] == [2]
    whole = loop.train(_cfg(subject, str(tmp_path / "b"), train={"epoch": 3}), CPU,
                       resume=False)
    assert whole.losses[4:] == resumed.losses and whole.losses[:4] == res.losses
    ref = _params(whole.state)
    for k, v in _params(resumed.state).items():
        assert torch.equal(v, ref[k]), k


def test_loop_mse_mode_keeps_the_error_map(subject, tmp_path):
    cfg = _cfg(subject, str(tmp_path), use_lpips=False, N_rand=32,
               sample_using_mse=True, train={"epoch": 1, "num_workers": 2})
    res = loop.train(cfg, CPU, resume=False)
    assert len(res.losses) == 2 and np.isfinite(res.losses).all()
    emap = np.load(os.path.join(cfg.result_dir, "latest_error.npy"))
    assert emap.shape == (2, 2, 28, 28) and (emap < 1000.0).any()


def test_loop_turns_tf32_off_on_the_card(subject, tmp_path, monkeypatch):
    """A caller that hands ``train`` a CUDA device gets float32 matmuls and
    cuDNN convolutions (the VGG loss's), as ``run.resolve_device`` sets
    them, before anything else runs."""
    class Reached(Exception):
        pass

    def stop():
        raise Reached
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", True)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(loop.native, "load", stop)
    with pytest.raises(Reached):
        loop.train(_cfg(subject, str(tmp_path)), torch.device("cuda"), resume=True)
    assert not torch.backends.cuda.matmul.allow_tf32
    assert not torch.backends.cudnn.allow_tf32


def test_device_seconds_counts_overlapping_device_work_once():
    """The busy share's device time is the union of the kernels' and
    copies' intervals: a copy on the stager's stream under a kernel adds
    nothing, a gap adds nothing, annotations and host events are left out."""
    from types import SimpleNamespace
    from torch.autograd import DeviceType

    def ev(lo, hi, dev=DeviceType.CUDA, note=False):
        return SimpleNamespace(time_range=SimpleNamespace(start=lo, end=hi),
                               device_type=dev, is_user_annotation=note)
    events = [ev(0, 100), ev(20, 60), ev(90, 150), ev(300, 310),
              ev(0, 1000, dev=DeviceType.CPU), ev(0, 1000, note=True)]
    assert loop._device_seconds(events) == pytest.approx(160e-6)
    assert loop._device_seconds([ev(0, 10, dev=DeviceType.CPU)]) is None


def test_profile_window_writes_a_trace(subject, tmp_path):
    cfg = _cfg(subject, str(tmp_path), train={"epoch": 1})
    res = loop.train(cfg, CPU, resume=False, profile_window=(1, 3))
    assert os.path.isfile(os.path.join(cfg.record_dir, "profile", "trace.json"))
    # the window outlasts the run's 2 steps; the CPU trace holds no device time
    assert res.profile["steps"] == 1 and res.profile["device_s"] is None


def _jax_side(cfg, exp):
    """The JAX config (own result and model dirs), spec and render spec of
    ``cfg``."""
    jcfg = JConfig(cfg.merged({"result_dir": os.path.join(exp, "res"),
                               "trained_model_dir": os.path.join(exp, "model")}).to_dict())
    return jcfg, jinb.build_model_spec(jcfg), jrend.make_render_spec(jcfg)


def _pngs(d):
    return {os.path.basename(p): cv2.imread(p, cv2.IMREAD_UNCHANGED)
            for p in sorted(glob.glob(os.path.join(d, "*.png")))}


@pytest.mark.parametrize("part", ["eval_ep", "vis_ep", "prune_using_geo"])
def test_eval_cadence_matches_jax(subject, tmp_path, part, monkeypatch):
    """``eval_ep``, ``vis_ep`` and ``prune_using_geo`` run after their
    epochs, and write what the JAX loop's calls (``validate``, the one-item
    ``evaluate_dataset`` of ``vis_ep``, ``occupancy_grid``)
    write for the same trained weights: float32, metrics at the tolerances
    of tests/test_torch_eval.py, the PNGs equal, the cube at atol 1e-5."""
    over = {"eval_ep": {"eval_ep": 2}, "vis_ep": {"vis_ep": 1},
            "prune_using_geo": {"prune_using_geo": True}}[part]
    cfg = _cfg(subject, str(tmp_path / "t"), **F32_MODE, **over)
    # the cube at res 24, not the loop's 128 (2.1 M points take minutes on a
    # loaded CPU; the card runs 128 in chip_smoke.py phase 9)
    grid = loop.occupancy_grid
    monkeypatch.setattr(loop, "occupancy_grid",
                        lambda *a, **kw: grid(*a, **dict(kw, res=24)))
    res = loop.train(cfg, CPU, resume=False)
    assert [e.epoch for e in res.epochs] == [0, 1]
    tree = jax.tree.map(jnp.asarray, bridge.tree_from_model(res.state.model))
    jcfg, jmspec, jrspec = _jax_side(cfg, str(tmp_path / "j"))
    metrics = lambda d, e: np.load(os.path.join(d, f"metrics_epoch{e}.npy"),
                                   allow_pickle=True).item()
    if part == "prune_using_geo":
        got = np.load(os.path.join(cfg.result_dir, "latest.npy"))
        item = TPoseDataset(cfg, "train").get_item(0, rng=np.random.default_rng(0))
        want, _ = jmesh.occupancy_grid(jcfg, jmspec, tree, item, False, res=24)
        assert got.shape == (24, 24, 24)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
        assert all(e.cube_s > 0 for e in res.epochs)
        return
    if part == "eval_ep":                 # after epoch 1 only: (1 + 1) % 2 == 0
        jloop.validate(jcfg, jmspec, jrspec, tree, 1)
        assert not os.path.exists(os.path.join(cfg.result_dir, "metrics_epoch0.npy"))
    else:                                 # after both epochs, one item each
        jrunner.evaluate_dataset(jcfg.replace(eval=True), jmspec, jrspec, tree,
                                 split="val", epoch=1, max_items=1, save_images=True)
        assert os.path.isdir(os.path.join(cfg.result_dir, "comparison_epoch0"))
        got = _pngs(os.path.join(cfg.result_dir, "comparison_epoch1"))
        want = _pngs(os.path.join(jcfg.result_dir, "comparison_epoch1"))
        assert sorted(got) == sorted(want) and len(got) == 3
        for name in want:
            np.testing.assert_array_equal(got[name], want[name], err_msg=name)
    got, want = metrics(cfg.result_dir, 1), metrics(jcfg.result_dir, 1)
    assert set(got) == set(want) and len(got["psnr"]) == len(want["psnr"]) > 0
    np.testing.assert_allclose(got["psnr"], want["psnr"], rtol=0, atol=1e-4)
    np.testing.assert_allclose(got["ssim"], want["ssim"], rtol=0, atol=1e-5)
    np.testing.assert_allclose(got["lpips"], want["lpips"], rtol=0, atol=1e-5)
    assert res.epochs[1].eval_s > 0 and res.epochs[1].cube_s < res.epochs[1].eval_s


def test_validation_skips_a_split_without_data(subject, tmp_path, capsys):
    cfg = _cfg(subject, str(tmp_path), eval_ep=1, vis_ep=1, train={"epoch": 1},
               val_dataset={"data_root": str(tmp_path / "none"),
                            "ann_file": str(tmp_path / "none" / "annots.npy")})
    res = loop.train(cfg, CPU, resume=False)
    out = capsys.readouterr().out
    assert len(res.losses) == 2
    assert "skipping val (no data)" in out and "skipping vis (no data)" in out


def test_checkpoint_round_trip_and_keeps_twenty(tmp_path, monkeypatch):
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml")).merged(train_net.TINY)
    mspec = inb.build_model_spec(cfg)
    state = create_train_state(cfg, inb.init_params(mspec, torch.Generator().manual_seed(1),
                                                    "cpu"))
    for p in state.model.parameters():
        p.grad = torch.ones_like(p)
    state.optimizer.step()
    state.step = 42
    monkeypatch.setattr(checkpoint, "MAX_KEPT", 3)
    d = str(tmp_path / "model")
    for epoch in range(5):
        checkpoint.save_checkpoint(d, epoch, state, {"step": 42, "epoch": epoch})
    assert sorted(os.listdir(d)) == ["2", "3", "4", "latest"]
    other = create_train_state(cfg, inb.init_params(mspec, torch.Generator().manual_seed(2),
                                                    "cpu"))
    meta = checkpoint.load_checkpoint(d, other)
    assert meta == {"epoch": 4, "step": 42} and other.step == 42
    for k, v in _params(other).items():
        assert torch.equal(v, _params(state)[k]), k
    a, b = other.optimizer.state_dict()["state"], state.optimizer.state_dict()["state"]
    assert a.keys() == b.keys() and all(torch.equal(a[i]["exp_avg_sq"], b[i]["exp_avg_sq"])
                                        for i in a)
    assert checkpoint.load_checkpoint(d, other, epoch=3)["epoch"] == 3
    assert checkpoint.load_checkpoint(str(tmp_path / "none"), other) is None
    # a checkpoint of another model build raises rather than starting over
    wide = cfg.merged({"network": {"occ": {"d_hidden": 32}}})
    with pytest.raises(RuntimeError):
        checkpoint.load_checkpoint(d, create_train_state(
            wide, inb.init_params(inb.build_model_spec(wide),
                                  torch.Generator().manual_seed(0), "cpu")))


def test_recorder_matches_jax(tmp_path):
    lines = []
    for mod in (recorder, jrecorder):
        r = mod.Recorder(str(tmp_path / mod.__name__), resume=False, enabled=False)
        for i in range(25):
            r.step += 1
            r.update({"loss": 1.0 / (i + 1), "psnr": 20.0 + i, "img_loss": 0.5})
        lines.append(r.console_line(5e-4, 1000, 0.25, 0.01))
        assert r.state_dict() == {"step": 25, "epoch": 0}
    assert lines[0] == lines[1]


# -- the command line ------------------------------------------------------------

def test_train_net_runs_the_loop_on_cpu(subject, tmp_path):
    opts = ["train_dataset.data_root", subject,
            "train_dataset.ann_file", os.path.join(subject, "annots.npy"),
            "smpl_meta", os.path.join(subject, "smpl-meta"), "num_train_frame", "2",
            "training_view", "[0,1]", "test_view", "[]", "ep_iter", "2",
            "train.epoch", "1", "use_lpips", "True", "patch_size", "8",
            "log_interval", "1", "result_dir", str(tmp_path)]
    buf = io.StringIO()
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        with redirect_stdout(buf):
            train_net.main(["--cfg_file", "configs/inb/inb_fake.yaml", "--device", "cpu",
                            "--tiny", "--no_resume"] + opts)
        out = buf.getvalue()
        assert "epoch 0: host data wait" in out and out.count("step: ") == 2
        buf = io.StringIO()
        with redirect_stdout(buf):
            train_net.main(["--cfg_file", "configs/inb/inb_fake.yaml", "--dry_run"])
        assert "total parameters: 18,001,911" in buf.getvalue()
        # --test: every epoch is done, so the resumed run only evaluates
        with redirect_stdout(io.StringIO()):
            train_net.main(["--cfg_file", "configs/inb/inb_fake.yaml", "--device", "cpu",
                            "--tiny", "--test", "test_dataset.data_root", subject,
                            "test_dataset.ann_file", os.path.join(subject, "annots.npy")]
                           + opts)
        metrics = np.load(os.path.join(str(tmp_path), "inb", "inb_fake", "metrics.npy"),
                          allow_pickle=True).item()
        assert set(metrics) == {"mse", "psnr", "ssim", "lpips"}
        assert len(metrics["psnr"]) == 1 and np.isfinite(metrics["psnr"]).all()
    finally:
        os.chdir(cwd)


GUARD = r"""
import os, sys
for name in ("cv2", "imageio", "PIL", "jax", "jaxlib", "tensorflow",
             "instant_nvr_tpu", "__graft_entry__"):
    sys.modules[name] = None            # any import of them raises ImportError
import torch
from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
from instant_nvr_tpu_torch.train import loop
from instant_nvr_tpu_torch import bridge, train_net
from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
root, exp = sys.argv[1], sys.argv[2]
write_fake_dataset(root, n_frames=2, n_views=2, H=64, W=64, supersample=1)
data = {"data_root": root, "ann_file": os.path.join(root, "annots.npy")}
cfg = make_cfg("configs/inb/inb_fake.yaml").merged(train_net.TINY).merged({
    "train_dataset": data, "smpl_meta": os.path.join(root, "smpl-meta"),
    "num_train_frame": 2, "training_view": [0, 1], "test_view": [],
    "use_lpips": True, "patch_size": 8, "ep_iter": 1, "train": {"epoch": 1},
    "result_dir": exp, "trained_model_dir": exp + "/model", "record_dir": exp + "/rec"})
res = loop.train(cfg, torch.device("cpu"), resume=False)
assert len(res.losses) == 1 and res.state.step == 1, res
# train_net's synthetic run and its patch batch, whose imports are lazy
import contextlib, io
buf = io.StringIO()
with contextlib.redirect_stdout(buf):
    train_net.main(["--device", "cpu", "--tiny", "--steps", "1"])
assert buf.getvalue().startswith("step 0: loss "), buf.getvalue()
patch = train_net.patch_batch_np(cfg)
assert patch["ray_mask"].shape == (cfg.patch_size ** 2,), sorted(patch)
# a committed JPEG fixture decodes to its digest, and a JPEG subject's item
import hashlib, json
import numpy as np
from instant_nvr_tpu_torch.datasets import fake_zju, image_ops
with open(os.path.join(fake_zju.JPEG_FIXTURES, "digests.json")) as f:
    digests = json.load(f)["images"]
name = "subject/Cam0/0000.jpg"
img = image_ops.read_image(os.path.join(fake_zju.JPEG_FIXTURES, name))
assert hashlib.sha256(img.tobytes()).hexdigest() == digests[name]["sha256"]
jroot = root + "_jpeg"
fake_zju.write_jpeg_subject(jroot)
jdata = {"data_root": jroot, "ann_file": os.path.join(jroot, "annots.npy")}
item = TPoseDataset(cfg.merged({"train_dataset": jdata,
                                "smpl_meta": os.path.join(jroot, "smpl-meta")}),
                    "train").get_item(0, rng=np.random.default_rng(0))
assert item["rgb"].shape[-1] == 3 and np.isfinite(item["rgb"]).all()
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in ("cv2", "imageio", "PIL", "jax", "jaxlib",
                                     "instant_nvr_tpu"))
assert not bad, bad
print("ok", res.losses[0])
"""


def test_loop_runs_without_cv2_imageio_pil_or_jax(tmp_path):
    """One training step, train_net's synthetic step and patch batch, a JPEG
    fixture decoded to its digest and one item of the JPEG subject, with
    cv2, imageio, PIL, jax and the JAX package blocked."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", GUARD, str(tmp_path / "subject"),
                          str(tmp_path / "exp")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1].startswith("ok")
