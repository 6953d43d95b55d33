"""The port's data layer against OpenCV, imageio and the JAX package's, on
the CPU.

cv2 and imageio serve here only as the oracle of ``image_ops``; the port
never imports them.  Tolerances: every image operation is bit-equal to its
OpenCV / imageio counterpart on these inputs (nearest and area resizes at
ratio 0.5 and 0.3, undistortion with zero and nonzero coefficients, the
projected-box polygon fill, erosion and dilation, PNG decoding of files
cv2 wrote); dataset items equal the JAX package's key by key, bit for bit,
dtype included, for the same index, ratio, focus and (epoch, position)
rng, on a subject written by the port and on one written by JAX.
"""
import os
import subprocess
import sys

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest

from instant_nvr_tpu.config import make_cfg as jax_make_cfg
from instant_nvr_tpu.datasets import fake_zju as jfake
from instant_nvr_tpu.datasets import prefetch as jprefetch
from instant_nvr_tpu.datasets import samplers as jsamplers
from instant_nvr_tpu.datasets import sampling as jsampling
from instant_nvr_tpu.datasets.tpose_dataset import TPoseDataset as JaxDataset
from instant_nvr_tpu.models import budget as jbudget
from instant_nvr_tpu.train.stages import stage_for_epoch as jax_stage_for_epoch
from instant_nvr_tpu.utils import native as jnative
from instant_nvr_tpu_torch.config import Config, make_cfg
from instant_nvr_tpu_torch.datasets import fake_zju, image_ops, prefetch, samplers
from instant_nvr_tpu_torch.datasets import sampling
from instant_nvr_tpu_torch.datasets.tpose_dataset import TPoseDataset
from instant_nvr_tpu_torch.models import budget
from instant_nvr_tpu_torch.ops import ray
from instant_nvr_tpu_torch.train.stages import stage_for_epoch
from instant_nvr_tpu_torch.utils import native

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(os.path.join(ROOT, "configs", "inb", f)
               for f in os.listdir(os.path.join(ROOT, "configs", "inb")))


# -- image ops against OpenCV and imageio ------------------------------------

@pytest.mark.parametrize("shape", [(37, 53), (37, 53, 3), (37, 53, 4), "smooth"])
def test_read_png_of_cv2_files(tmp_path, rng, shape):
    """cv2 (libpng) picks a row filter per row: the smooth image makes it
    use Sub, Up, Average and Paeth."""
    if shape == "smooth":
        yy, xx = np.mgrid[:120, :90]
        img = np.stack([(xx // 2) % 256, (yy // 3) % 256, ((xx + yy) // 5) % 256],
                       -1).astype(np.uint8)
    else:
        img = rng.integers(0, 256, shape).astype(np.uint8)
        img[:10] = 7
    path = str(tmp_path / "a.png")
    cv2.imwrite(path, img)
    want = imageio.imread(path)
    got = image_ops.read_png(path)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("shape", [(16, 24), (16, 24, 3), (16, 24, 4)])
def test_write_png_round_trip(tmp_path, rng, shape):
    img = rng.integers(0, 256, shape).astype(np.uint8)
    path = str(tmp_path / "b.png")
    image_ops.write_png(path, img)
    np.testing.assert_array_equal(image_ops.read_png(path), img)
    np.testing.assert_array_equal(imageio.imread(path), img)


def test_unreadable_images_raise_naming_the_file(tmp_path, rng):
    jpg = str(tmp_path / "photo.jpg")
    cv2.imwrite(jpg, rng.integers(0, 256, (8, 8, 3)).astype(np.uint8))
    with pytest.raises(ValueError, match="photo.jpg.*JPEG"):
        image_ops.read_png(jpg)
    pal = str(tmp_path / "sixteen.png")
    cv2.imwrite(pal, rng.integers(0, 65535, (8, 8)).astype(np.uint16))
    with pytest.raises(ValueError, match="sixteen.png.*bit depth 16"):
        image_ops.read_png(pal)


def test_rodrigues_matches_cv2(rng):
    for r in [np.zeros(3), np.array([0.0, 1e-20, 0.0])] + list(rng.normal(size=(50, 3))):
        np.testing.assert_array_equal(image_ops.rodrigues(r), cv2.Rodrigues(r)[0])


@pytest.mark.parametrize("side,ratio", [(96, 0.5), (96, 0.3), (512, 0.3), (90, 0.5)])
def test_resize_matches_cv2(rng, side, ratio):
    img = rng.random((side, side, 3)).astype(np.float32)
    msk = (rng.random((side, side)) < 0.5).astype(np.uint8) * 5
    W = H = int(side * ratio)
    np.testing.assert_array_equal(image_ops.resize_area(img, W, H),
                                  cv2.resize(img, (W, H), interpolation=cv2.INTER_AREA))
    np.testing.assert_array_equal(image_ops.resize_nearest(msk, W, H),
                                  cv2.resize(msk, (W, H), interpolation=cv2.INTER_NEAREST))


@pytest.mark.parametrize("dist", ["zero", "barrel", "pincushion"])
def test_undistort_matches_cv2(rng, dist):
    D = {"zero": np.zeros((5, 1)),
         "barrel": np.array([-0.25, 0.08, 0.001, -0.002, -0.01]),
         "pincushion": np.array([0.12, -0.03, -0.0015, 0.001, 0.004])}[dist]
    K = np.array([[190.0, 0, 47.3], [0, 205.0, 51.1], [0, 0, 1]])
    img = rng.random((96, 96, 3)).astype(np.float32)
    msk = (rng.random((96, 96)) < 0.5).astype(np.uint8)
    np.testing.assert_array_equal(image_ops.undistort(img, K, D), cv2.undistort(img, K, D))
    np.testing.assert_array_equal(image_ops.undistort(msk, K, D), cv2.undistort(msk, K, D))
    np.testing.assert_array_equal(image_ops.undistort(msk * 255, K, D),
                                  cv2.undistort(msk * 255, K, D))


def test_fill_convex_poly_matches_cv2(rng):
    """Random quads: convex ones inside the image, and arbitrary ones that
    leave it on any side (the clipped-edge rules)."""
    for t in range(1500):
        if t % 3 == 0:
            pts = rng.integers(-40, 120, (4, 2))
        else:
            c, r = rng.uniform(10, 60, 2), rng.uniform(3, 50)
            ang = np.sort(rng.uniform(0, 2 * np.pi, 4))
            pts = np.round(np.stack([c[0] + r * np.cos(ang),
                                     c[1] + r * np.sin(ang)], -1)).astype(int)
        want = np.zeros((64, 80), np.uint8)
        cv2.fillPoly(want, [pts], 1)
        got = image_ops.fill_convex_poly(np.zeros((64, 80), np.uint8), pts, 1)
        np.testing.assert_array_equal(got, want, err_msg=str(pts.tolist()))


def test_bound_mask_matches_jax(rng):
    """The projected-box mask of the samplers, boxes partly outside the
    image included."""
    K = np.array([[192.0, 0, 48], [0, 192.0, 48], [0, 0, 1]])
    for _ in range(40):
        c = rng.normal(scale=0.2, size=3)
        bounds = np.stack([c - rng.uniform(0.1, 0.5, 3), c + rng.uniform(0.1, 0.5, 3)])
        R = cv2.Rodrigues(rng.normal(scale=0.3, size=3))[0]
        T = np.array([[0.0], [0.0], [rng.uniform(1.0, 2.0)]])
        np.testing.assert_array_equal(sampling._bound_2d_mask(bounds, K, R, T, 96, 96),
                                      jsampling._bound_2d_mask(bounds, K, R, T, 96, 96))


@pytest.mark.parametrize("size", [3, 4, 5, 10])
def test_morphology_matches_cv2(rng, size):
    msk = (rng.random((60, 70)) < 0.4).astype(np.uint8)
    kernel = np.ones((size, size), np.uint8)
    np.testing.assert_array_equal(image_ops.erode(msk, size), cv2.erode(msk, kernel))
    np.testing.assert_array_equal(image_ops.dilate(msk, size), cv2.dilate(msk, kernel))


# -- the native host library ---------------------------------------------------

def test_native_library_builds_beside_the_kernels_and_matches(rng):
    so = native.library_path()
    native.load()
    assert so.exists() and so.parent == native.BUILD_DIR
    assert so.parent.parts[-2:] == ("build", "torch_kernels")
    K = np.array([[300.0, 0, 60], [0, 310.0, 50], [0, 0, 1]])
    R = cv2.Rodrigues(np.array([0.1, 0.4, -0.2]))[0]
    T = np.array([[0.1], [-0.2], [1.5]])
    coords = rng.integers(0, 120, (500, 2))
    o, d = native.ray_dirs(K, R, T, coords)
    po, pd = ray.rays_for_coords_np(K, R, T, coords)
    np.testing.assert_allclose(o, po, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(d, pd, rtol=1e-6, atol=1e-7)
    bounds = np.array([[-0.3, -0.3, -0.3], [0.3, 0.3, 0.3]], np.float32)
    near, far, hit = native.near_far(bounds, o, d)
    pn, pf, ph = ray.get_near_far_np(bounds, o, d)
    np.testing.assert_array_equal(hit, ph)
    np.testing.assert_allclose(near, pn, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(far, pf, rtol=1e-5, atol=1e-6)
    # the weighted draw is the JAX package's, stream and all
    msk = (rng.random((40, 50)) < 0.3).astype(np.uint8)
    msk[:3, :3] = 13
    box = (rng.random((40, 50)) < 0.8).astype(np.uint8)
    assert jnative.available()
    np.testing.assert_array_equal(native.sample_pixels(msk, box, 30, 20, 50, 1234),
                                  jnative.sample_pixels(msk, box, 30, 20, 50, 1234))
    # the plain draw covers the same pools
    plain = sampling._weighted_pick(msk, box, 30, 20, 50, np.random.default_rng(0))
    assert plain.shape == (100, 2) and (msk[tuple(plain[:30].T)] == 1).all()


def test_native_build_failure_raises(tmp_path, monkeypatch):
    bad = tmp_path / "nvrhost.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building nvrhost.cpp failed"):
        native.build()


# -- the dataset against the JAX package's --------------------------------------

@pytest.fixture(scope="module")
def subjects(tmp_path_factory):
    """{writer: root}: the same 2-frame x 2-view 96^2 subject written by the
    port and by the JAX package."""
    out = {}
    for name, write in (("port", fake_zju.write_fake_dataset),
                        ("jax", jfake.write_fake_dataset)):
        root = str(tmp_path_factory.mktemp(f"zju_{name}"))
        write(root, n_frames=2, n_views=2, H=96, W=96)
        out[name] = root
    return out


def _cfgs(root, **extra):
    base = jax_make_cfg(os.path.join(ROOT, "configs/inb/inb_377.yaml"))
    cj = base.merged(jfake.fake_cfg_overrides(root, n_frames=2)).merged(
        {"training_view": [0, 1], "test_view": [], "use_lpips": False,
         "patch_size": 16}).merged(extra)
    return cj, Config(cj.to_dict())


def test_fake_subjects_agree(subjects):
    """The port's writer gives the JAX writer's files: every array and every
    decoded image."""
    a, b = subjects["port"], subjects["jax"]
    files = sorted(os.path.relpath(os.path.join(d, f), a)
                   for d, _, fs in os.walk(a) for f in fs)
    assert files == sorted(os.path.relpath(os.path.join(d, f), b)
                           for d, _, fs in os.walk(b) for f in fs)
    for f in files:
        if f.endswith(".png"):
            np.testing.assert_array_equal(image_ops.read_png(os.path.join(a, f)),
                                          imageio.imread(os.path.join(b, f)), err_msg=f)
        elif f != "annots.npy":
            x, y = (np.load(os.path.join(r, f), allow_pickle=True) for r in (a, b))
            if x.dtype == object:
                x, y = x.item(), y.item()
                for k in x:
                    np.testing.assert_array_equal(x[k], y[k], err_msg=f)
            else:
                np.testing.assert_array_equal(x, y, err_msg=f)
    ann = [np.load(os.path.join(r, "annots.npy"), allow_pickle=True).item() for r in (a, b)]
    assert ann[0]["ims"] == ann[1]["ims"]
    for k in ("K", "D", "R", "T"):
        np.testing.assert_array_equal(np.array(ann[0]["cams"][k]), np.array(ann[1]["cams"][k]))


def _assert_items_equal(got, want, what=""):
    assert set(got) == set(want), set(got) ^ set(want)
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype)
        np.testing.assert_array_equal(g, w, err_msg=f"{what} {k}")


def _items(cj, cp, split="train", **kw):
    jds, pds = JaxDataset(cj, split), TPoseDataset(cp, split)
    assert len(jds) == len(pds) == 4
    for index in range(len(jds)):
        seed = np.random.SeedSequence(entropy=(7, 1, index))
        want = jds.get_item(index, rng=np.random.default_rng(seed), **kw)
        got = pds.get_item(index, rng=np.random.default_rng(seed), **kw)
        yield index, got, want


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("sampler", ["train", "patch"])
@pytest.mark.parametrize("stage", [0, 2])
def test_get_item_matches_jax(subjects, writer, sampler, stage):
    """inb_377's stages 0 (ratio 0.3) and 2 (ratio 0.5, head focus), the
    train (body/face-weighted) and patch samplers."""
    cj, cp = _cfgs(subjects[writer], use_lpips=sampler == "patch")
    cj, cp = jax_stage_for_epoch(cj, stage), stage_for_epoch(cp, stage)
    assert cp.ratio == (0.3 if stage == 0 else 0.5)
    for index, got, want in _items(cj, cp, ratio=cp.ratio,
                                   sample_focus=cp.get("sample_focus", "")):
        _assert_items_equal(got, want, f"item {index}")
        if sampler == "patch":
            assert got["rgb"].shape == (256, 3) and "patch_hw" in got


def test_eval_items_and_cached_images_match_jax(subjects):
    """The full-image (eval) sampler, twice: the second read comes from the
    image cache, whose byte budget here holds one entry."""
    cj, cp = _cfgs(subjects["port"], dataset_cache_bytes=60_000)
    jds, pds = JaxDataset(cj, "test"), TPoseDataset(cp, "test")
    for index in (0, 1, 0):
        _assert_items_equal(pds.get_item(index), jds.get_item(index), f"item {index}")
    assert len(pds._img_cache) == 1 and pds._img_cache_bytes <= 60_000


def test_mse_sampler_and_error_map_match_jax(subjects, tmp_path):
    cj, cp = _cfgs(subjects["port"], sample_using_mse=True, result_dir=str(tmp_path))
    jds, pds = JaxDataset(cj, "train"), TPoseDataset(cp, "train")
    err = np.random.default_rng(5).random((2, 2, 48, 48)).astype(np.float32)
    for ds in (jds, pds):
        ds.init_error_map(48, 48)
        ds.error_map[:] = err
    coord = np.array([[1, 2], [30, 40]])
    for ds in (jds, pds):
        ds.update_error_map(coord, np.array([7.0, 8.0]), 1, 0)
    np.testing.assert_array_equal(pds.error_map, jds.error_map)
    for index in range(4):
        seed = np.random.SeedSequence(entropy=(7, 0, index))
        _assert_items_equal(pds.get_item(index, rng=np.random.default_rng(seed)),
                            jds.get_item(index, rng=np.random.default_rng(seed)))
    pds.save_error_map(str(tmp_path))
    pds.error_map = None
    pds.load_error_map(str(tmp_path))
    np.testing.assert_array_equal(pds.error_map, jds.error_map)


def test_pruned_sampling_matches_jax(subjects):
    """The consumption side of prune_using_geo: an occupancy cube installed
    in memory restricts the train sampler's pools."""
    cj, cp = _cfgs(subjects["port"], prune_using_geo=True)
    g = np.linspace(-1, 1, 24)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    cube = (1.0 - np.sqrt(xx ** 2 + yy ** 2 + zz ** 2)).astype(np.float32)
    jds, pds = JaxDataset(cj, "train"), TPoseDataset(cp, "train")
    jds.set_prune_geometry(cube)
    pds.set_prune_geometry(cube)
    for index in range(4):
        seed = np.random.SeedSequence(entropy=(7, 0, index))
        _assert_items_equal(pds.get_item(index, rng=np.random.default_rng(seed)),
                            jds.get_item(index, rng=np.random.default_rng(seed)))


def test_jpeg_images_raise(subjects, tmp_path):
    """Baseline JPEG images are decoded (tests/test_torch_jpeg.py,
    tests/test_torch_realdata.py); a kind the decoder refuses raises naming
    the file, with no fallback reader."""
    import shutil
    root = str(tmp_path / "jpeg_subject")
    shutil.copytree(subjects["port"], root)
    path = os.path.join(root, "images", "Cam0", "0000.png")
    img = imageio.imread(path)
    # progressive JPEG bytes under a .png name
    cv2.imencode(".jpg", img, [cv2.IMWRITE_JPEG_PROGRESSIVE, 1])[1].tofile(path)
    _, cp = _cfgs(root)
    with pytest.raises(ValueError, match="0000.png: progressive JPEG is not supported"):
        TPoseDataset(cp, "train").get_item(0, rng=np.random.default_rng(0))


def test_schp_palette_and_helpers_match_jax():
    from instant_nvr_tpu.datasets import tpose_dataset as jtd
    from instant_nvr_tpu_torch.datasets import tpose_dataset as td
    np.testing.assert_array_equal(td.schp_palette(20), jtd.schp_palette(20))
    rng = np.random.default_rng(1)
    xyz = rng.normal(size=(100, 3)).astype(np.float32)
    np.testing.assert_array_equal(td.get_bounds(xyz, 0.05), jtd.get_bounds(xyz, 0.05))
    msk = (rng.random((50, 50)) < 0.5).astype(np.uint8)
    for border in (5, 10):
        np.testing.assert_array_equal(td.erode_edge_mask(msk, border),
                                      jtd.erode_edge_mask(msk, border))
    poses = rng.normal(scale=0.3, size=(24, 3))
    joints = rng.normal(size=(24, 3)).astype(np.float32)
    parents = np.concatenate([[0], np.arange(23)])
    np.testing.assert_array_equal(td.get_rigid_transformation_np(poses, joints, parents),
                                  jtd.get_rigid_transformation_np(poses, joints, parents))


# -- budgets, stages, samplers, prefetch ----------------------------------------

def test_estimate_budgets_matches_jax(subjects):
    cj, cp = _cfgs(subjects["port"], N_samples=16, N_rand=256)
    want = jbudget.estimate_budgets(cj, JaxDataset(cj, "train"))
    got = budget.estimate_budgets(cp, TPoseDataset(cp, "train"))
    assert got == want and 0 < got[0] <= 1


def test_apply_auto_budget_persists(subjects, tmp_path):
    _, cp = _cfgs(subjects["port"], auto_budget=True, N_samples=8,
                  trained_model_dir=str(tmp_path))
    first = budget.apply_auto_budget(cp)
    assert os.path.exists(tmp_path / "budgets.json")
    again = budget.apply_auto_budget(cp.merged({"N_samples": 64}))
    for k in ("cull_budget", "part_budget", "part_budget_scales"):
        assert first[k] == again[k]
    assert budget.apply_auto_budget(cp.merged({"auto_budget": False})) is not None


def _plain(v):
    """A config tree as plain dicts and lists (the two packages' Config
    classes never compare equal)."""
    if hasattr(v, "to_dict"):
        v = v.to_dict()
    if isinstance(v, dict):
        return {k: _plain(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_plain(x) for x in v]
    return v


@pytest.mark.parametrize("path", YAMLS, ids=os.path.basename)
def test_stage_for_epoch_matches_jax(path):
    cwd = os.getcwd()
    os.chdir(ROOT)
    try:
        cj, cp = jax_make_cfg(path), make_cfg(path)
    finally:
        os.chdir(cwd)
    for epoch in range(8):
        assert _plain(stage_for_epoch(cp, epoch)) == \
            _plain(jax_stage_for_epoch(cj, epoch)), epoch


@pytest.mark.parametrize("mask", ["sparse", "dense", "one_pixel", "last_pixel", "uint8_focus"])
def test_pick_nonzero_matches_argwhere(mask):
    """The patch sampler's pixel pick: ``np.argwhere(ref)[rng.integers(0,
    n)]`` for every draw, and the generator left where argwhere's pick
    leaves it."""
    g = np.random.default_rng(11)
    ref = {"sparse": g.random((61, 47)) < 0.02, "dense": g.random((64, 64)) < 0.7,
           "one_pixel": np.zeros((33, 20), bool), "last_pixel": np.zeros((9, 9), bool),
           "uint8_focus": (g.random((40, 50)) < 0.3).astype(np.uint8)}[mask]
    if mask == "one_pixel":
        ref[17, 3] = True
    if mask == "last_pixel":
        ref[-1, -1] = True
    a, b = np.random.default_rng(5), np.random.default_rng(5)
    coords = np.argwhere(ref)
    for _ in range(50):
        assert sampling.pick_nonzero(ref, a) == tuple(coords[b.integers(0, len(coords))])
    assert a.integers(0, 2 ** 31) == b.integers(0, 2 ** 31)


def test_cached_images_are_read_only(subjects):
    """The image cache serves its arrays read-only: a write raises, and
    the items built from them stay the JAX package's."""
    cj, cp = _cfgs(subjects["port"])
    jds, pds = JaxDataset(cj, "train"), TPoseDataset(cp, "train")
    img, msk, orig_msk, sem, _, _, _ = pds._load_image(0, cp.ratio)
    for a in (img, msk, orig_msk, *sem.values()):
        with pytest.raises(ValueError, match="read-only"):
            a[0] = 0
    again = pds._load_image(0, cp.ratio)
    assert again[0] is img and again[1] is msk
    rng_j, rng_p = np.random.default_rng(3), np.random.default_rng(3)
    for index in (0, 1, 0):
        _assert_items_equal(pds.get_item(index, rng=rng_p), jds.get_item(index, rng=rng_j),
                            f"item {index}")


def test_samplers_match_jax():
    a, b = samplers.FrameSampler(24, 3, 2), jsamplers.FrameSampler(24, 3, 2)
    assert list(a) == list(b) and len(a) == len(b)
    for n, iters, seed in ((5, 12, 0), (8, 3, 2), (1, 4, 7)):
        for shuffle in (True, False):
            s = samplers.IterationBasedSampler(n, iters, seed, shuffle)
            js = jsamplers.IterationBasedSampler(n, iters, seed, shuffle)
            for epoch in range(3):
                assert s.epoch(epoch) == js.epoch(epoch)
    idx = list(range(11))
    for pad in (True, False):
        for r in range(4):
            assert samplers.shard_indices(idx, r, 4, pad) == \
                jsamplers.shard_indices(idx, r, 4, pad)


@pytest.mark.parametrize("workers", [1, 3])
def test_prefetcher_order_and_close(workers):
    import threading
    import time

    def slow(i):
        time.sleep(0.002 * ((i * 7) % 5))
        return {"i": i}

    idx = list(range(40))
    got = [b["i"] for b in prefetch.Prefetcher(slow, idx, depth=4,
                                               device_put=lambda b: dict(b, put=1),
                                               workers=workers)]
    want = [b["i"] for b in jprefetch.Prefetcher(slow, idx, depth=4, workers=workers)]
    assert got == want == idx
    # closing after one batch stops every thread
    before = threading.active_count()
    pf = prefetch.Prefetcher(slow, idx, depth=4, workers=workers)
    next(iter(pf))
    pf.close()
    assert not any(t.is_alive() for t in pf._threads)
    assert threading.active_count() <= before
    # a producer's error reaches the consumer

    def bad(i):
        if i == 5:
            raise KeyError("item 5")
        return {"i": i}
    with pytest.raises(KeyError, match="item 5"):
        for _ in prefetch.Prefetcher(bad, idx, workers=workers):
            pass


def test_device_stager_on_the_cpu():
    import torch
    item = {"a": np.arange(6, dtype=np.float32).reshape(2, 3), "n": np.int32(3)}
    stager = prefetch.DeviceStager(torch.device("cpu"),
                                   lambda it, put: {k: put(v) for k, v in it.items()})
    staged = stager(item)
    assert staged.copied is None and stager.stream is None
    got_item, batch = stager.ready(staged)
    assert got_item is item
    assert torch.equal(batch["a"], torch.arange(6.0).reshape(2, 3))
    assert batch["n"].shape == () and int(batch["n"]) == 3


def test_data_modules_never_import_cv2_imageio_or_jax():
    code = ("import sys\n"
            "import instant_nvr_tpu_torch.datasets.tpose_dataset\n"
            "import instant_nvr_tpu_torch.datasets.fake_zju\n"
            "import instant_nvr_tpu_torch.datasets.prefetch\n"
            "import instant_nvr_tpu_torch.train.loop, instant_nvr_tpu_torch.models.lpips\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'cv2', 'imageio', 'PIL', 'instant_nvr_tpu'))\n"
            "assert not bad, bad\n"
            "print('ok')\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"
