"""The port's reader of the JAX package's orbax checkpoints, on the CPU.

- zstd (``csrc/zstd.cpp``): the committed corpus (zarr v2 chunks that
  tensorstore compressed at levels 1, 3, 9, 19 and 22) decodes to its
  digests and to tensorstore's own array read, bit for bit, and so do
  frames tensorstore writes here; a content checksum is checked against a
  plain Python XXH64, CRC32C against a plain bitwise one; damaged frames
  and OCDBT nodes decode or raise ``ValueError`` in a subprocess and under
  AddressSanitizer and UBSan (a damaged node always raises: its CRC32C).
- the reader (``train/orbax_format.py``): leaf for leaf (bytes, dtype,
  shape) equal to orbax's ``_restore_numpy`` on checkpoints the JAX package
  writes here (Adam with float32 and bfloat16 moments, ``weight_decay``
  with ``mlp_weight_decay``, radam, sgd, a ``latest`` copy, a run whose
  older epochs were garbage-collected), and the keys and values of OCDBT
  stores with interior B-tree nodes and of multi-chunk zarr arrays equal to
  tensorstore's.
- the model: the committed tiny checkpoints (``train.TINY`` widths of
  inb_377, 3 JAX train steps) render the committed rays as the JAX package
  rendered them (``expected.npz``; the bf16 tolerance of
  ``tests/test_torch_model.py``, atol 1e-3); one resumed step in each
  package agrees at ``tests/test_torch_train.py``'s float32 tolerances
  (loss and stats rtol 1e-5, parameters rtol 1e-4 / atol 1e-6 of the
  leaf's largest entry); ``run --type evaluate`` on a JAX-written directory
  gives the JAX package's ``metrics.npy`` at ``tests/test_torch_eval.py``'s
  bounds; the loop resumes from such a directory.
- ``tools/import_jax_ckpt.py``'s output loads bit for bit; the writer of
  the JAX layout (``tools/make_fixtures.py``) is read back by orbax and by
  the JAX package's ``load_checkpoint``; unmappable states and directories
  in neither layout raise; the reader, the converter and ``load_weights``
  run with jax, orbax, tensorstore, instant_nvr_tpu, cv2, imageio and PIL
  blocked.

The fixtures under ``instant_nvr_tpu_torch/train/fixtures/orbax`` are
rewritten by ``python tests/test_torch_orbax.py`` (jax, orbax and
tensorstore; re-run the tests after).
"""
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from __graft_entry__ import _flagship  # noqa: E402
from instant_nvr_tpu.models import inb as jinb  # noqa: E402
from instant_nvr_tpu.renderer import inb_renderer as jrend  # noqa: E402
from instant_nvr_tpu.train import checkpoint as jck  # noqa: E402
from instant_nvr_tpu.train import state as jstate  # noqa: E402
from instant_nvr_tpu.train import step as jstep  # noqa: E402
from instant_nvr_tpu_torch import bridge  # noqa: E402
from instant_nvr_tpu_torch.config import Config  # noqa: E402
from instant_nvr_tpu_torch.datasets import synthetic  # noqa: E402
from instant_nvr_tpu_torch.renderer import inb_renderer as rend  # noqa: E402
from instant_nvr_tpu_torch.run import build  # noqa: E402
from instant_nvr_tpu_torch.tools import import_jax_ckpt, make_fixtures  # noqa: E402
from instant_nvr_tpu_torch.train import checkpoint, orbax_format  # noqa: E402
from instant_nvr_tpu_torch.train import state as tstate  # noqa: E402
from instant_nvr_tpu_torch.train import step as tstep  # noqa: E402

FIX = os.path.join(ROOT, "instant_nvr_tpu_torch", "train", "fixtures", "orbax")
CKPTS = {"adam_f32": {}, "adam_bf16": {"train": {"moment_dtype": "bfloat16"}}}
TRAIN_STEPS = 3
SCENE = dict(n_verts=600, grid=16, H=32, W=32, n_rays=256)
LEVELS = (1, 3, 9, 19, 22)
F32_MODE = {"mlp_dtype": "float32", "grid_compute_dtype": "float32"}
VARIANTS = {"adam": {}, "adam_bf16": {"train": {"moment_dtype": "bfloat16"}},
            "wd_mlp": {"train": {"weight_decay": 1e-4}, "mlp_weight_decay": 0.5},
            "radam": {"train": {"optim": "radam"}}, "sgd": {"train": {"optim": "sgd"}}}
CPU = torch.device("cpu")


# -- helpers ----------------------------------------------------------------------

def sha(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def raw_leaf(v):
    """(bytes view, dtype name) of a leaf of either reader."""
    if isinstance(v, torch.Tensor):
        assert v.dtype == torch.bfloat16
        return v.view(torch.uint16).numpy(), "bfloat16"
    v = np.asarray(v)
    if v.dtype.name == "bfloat16":           # orbax's ml_dtypes leaves
        return v.view(np.uint16), "bfloat16"
    return v, v.dtype.name


def assert_trees_equal(mine, ref, where=""):
    """Same structure; every leaf with equal bytes, dtype and shape."""
    a = {".".join(p): v for p, _, v in orbax_format.leaves(mine)}
    b = {".".join(p): v for p, _, v in orbax_format.leaves(ref)}
    assert a.keys() == b.keys(), (where, sorted(set(a) ^ set(b)))
    for k in a:
        if b[k] is None:
            assert a[k] is None, (where, k)
            continue
        (x, tx), (y, ty) = raw_leaf(a[k]), raw_leaf(b[k])
        assert tx == ty and x.shape == y.shape and x.tobytes() == y.tobytes(), (where, k)


def leaf_digests(tree):
    out = {}
    for p, _, v in orbax_format.leaves(tree):
        if v is None:
            continue
        x, dt = raw_leaf(v)
        out[".".join(p)] = {"sha256": sha(x), "shape": list(x.shape), "dtype": dt}
    return out


def tiny_cfg(overrides=None, mode=None):
    """(JAX config, port config) at train_net.TINY widths of inb_377."""
    cfg_j, *_ = _flagship(tiny=True)
    cfg_j = cfg_j.merged(overrides or {})
    if mode:
        cfg_j = cfg_j.merged(mode)
    return cfg_j, Config(cfg_j.to_dict())


def tiny_yaml(tmp_path, overrides) -> str:
    """A YAML of inb_377 at train_net.TINY widths (tiny_cfg's config)."""
    import yaml
    from instant_nvr_tpu_torch import train_net
    path = str(tmp_path / "tiny.yaml")
    with open(path, "w") as f:
        yaml.safe_dump({"parent_cfg": os.path.join(ROOT, "configs/inb/inb_377.yaml"),
                        **train_net.TINY, **overrides}, f)
    return path


def tiny_batch():
    cfg_j, mspec, rspec, lw, batch, batch_np = _flagship(tiny=True)
    return batch_np


def jax_state(cfg_j, seed=0, fill=None):
    """A JAX TrainState for ``cfg_j``: init_params(key(seed)); ``fill``
    (a numpy Generator) replaces every float leaf of the optimizer state and
    the parameters' non-padding entries with seeded values."""
    mspec = jinb.build_model_spec(cfg_j)
    params = jinb.init_params(jax.random.key(seed), mspec)
    opt, _ = jstate.make_optimizer(cfg_j)
    st = jstate.create_train_state(params, opt, mspec)
    if fill is not None:
        def rand(path, x):
            if not jnp.issubdtype(x.dtype, jnp.floating):
                return jnp.asarray(fill.integers(1, 100), x.dtype).reshape(x.shape)
            v = fill.standard_normal(x.shape).astype(np.float32) * 1e-2
            if any(getattr(k, "name", None) == "nu" for k in path):
                v = np.abs(v) * 1e-2                    # a second moment
            if x.ndim and x.shape[0] > 1000:           # keep tile padding zero
                v[np.asarray(x == 0).all(axis=tuple(range(1, x.ndim)))] = 0
            return jnp.asarray(v).astype(x.dtype)
        st = st._replace(opt_state=jax.tree_util.tree_map_with_path(rand, st.opt_state),
                         step=jnp.asarray(7, jnp.int32))
    return mspec, opt, st


def jax_train(cfg_j, steps, batch_np):
    """``steps`` of the JAX package's train step from init_params(key(0))."""
    mspec, opt, st = jax_state(cfg_j)
    step = jax.jit(jstep.make_train_step(mspec, jrend.make_render_spec(cfg_j),
                                         jstep.make_loss_weights(cfg_j), opt))
    batch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    for i in range(steps):
        st, _ = step(st, batch, jax.random.key(i))
    return mspec, opt, st


def scene_batch():
    """The rays of expected.npz: the tiny synthetic scene, 256 rays (the
    port's synthetic module gives JAX's arrays bit for bit)."""
    s = synthetic.make_scene(n_verts=SCENE["n_verts"], grid=SCENE["grid"])
    v = synthetic.render_gt(s, H=SCENE["H"], W=SCENE["W"])
    return synthetic.make_batch(s, v, n_rays=SCENE["n_rays"])


def jax_render(cfg_j, params, batch_np):
    mspec = jinb.build_model_spec(cfg_j)
    fn = jax.jit(jrend.render_rays, static_argnums=(0, 1, 4))
    out = fn(mspec, jrend.make_render_spec(cfg_j), params,
             {k: jnp.asarray(v) for k, v in batch_np.items()}, False, jax.random.key(0))
    return np.asarray(out["rgb_map"]), np.asarray(out["acc_map"])


def corpus_arrays():
    """The corpus's data kinds (seeded)."""
    rng = np.random.default_rng(0)
    runs = np.repeat(rng.standard_normal(400).astype(np.float32),
                     rng.integers(1, 60, 400))[:8192]
    pattern = np.tile(rng.standard_normal(37).astype(np.float32), 222)[:8192]
    # over 128 KiB: a frame of several blocks; 4 mantissa bits kept
    big = rng.standard_normal(33000).astype(np.float32) * 0.02
    big = (big.view(np.uint32) & 0xFFF80000).view(np.float32)
    return {"weights": (rng.standard_normal(4096) * 0.01).astype(np.float32),
            "zeros": np.zeros(8192, np.float32), "runs": runs, "pattern": pattern,
            "big": big}


def ts_write_chunk(tmp, arr, level, chunks=None):
    """The chunk bytes tensorstore's zarr v2 driver writes for ``arr`` at
    zstd ``level`` (one chunk unless ``chunks``)."""
    path = os.path.join(tmp, f"z{level}_{arr.dtype.str}_{arr.size}")
    shutil.rmtree(path, ignore_errors=True)
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": path},
                 "metadata": {"shape": list(arr.shape), "chunks": chunks or list(arr.shape),
                              "dtype": arr.dtype.str,
                              "compressor": {"id": "zstd", "level": level}}},
                create=True).result()
    t.write(arr).result()
    with open(os.path.join(path, ".".join("0" * arr.ndim) or "0"), "rb") as f:
        return f.read()


def ts_decode(tmp, frame, nbytes):
    """Tensorstore's own read of ``frame`` as the one chunk of a uint8 zarr
    v2 array of ``nbytes``."""
    path = tempfile.mkdtemp(dir=tmp)
    with open(os.path.join(path, ".zarray"), "w") as f:
        json.dump({"zarr_format": 2, "shape": [nbytes], "chunks": [nbytes], "dtype": "|u1",
                   "compressor": {"id": "zstd", "level": 1}, "fill_value": None,
                   "order": "C", "filters": None}, f)
    with open(os.path.join(path, "0"), "wb") as f:
        f.write(frame)
    t = ts.open({"driver": "zarr", "kvstore": {"driver": "file", "path": path}}).result()
    return t.read().result().tobytes()


def decode(frame, nbytes):
    out = np.empty(nbytes, np.uint8)
    n = orbax_format.decompress_into(frame, out, "frame")
    assert n == nbytes
    return out.tobytes()


def digests():
    with open(os.path.join(FIX, "digests.json")) as f:
        return json.load(f)


def corpus_names():
    if not os.path.exists(os.path.join(FIX, "digests.json")):
        return []                     # before the first regenerate()
    return sorted(digests()["corpus"])


# -- fixtures (python tests/test_torch_orbax.py) -------------------------------------

def regenerate(out=FIX):
    """Rewrite the committed fixtures: the two trained tiny checkpoints,
    expected.npz, the zstd corpus and digests.json."""
    shutil.rmtree(out, ignore_errors=True)
    os.makedirs(os.path.join(out, "corpus"))
    record = {"checkpoints": {}, "corpus": {}, "scene": SCENE,
              "train_steps": TRAIN_STEPS}
    batch = scene_batch()
    expected = {k: batch[k] for k in ("ray_o", "ray_d", "near", "far")}
    with tempfile.TemporaryDirectory() as tmp:
        for name, ov in CKPTS.items():
            cfg_j, _ = tiny_cfg(ov)
            _, _, st = jax_train(cfg_j, TRAIN_STEPS, tiny_batch())
            d = os.path.join(tmp, name)
            jck.save_checkpoint(d, 0, st, {"step": TRAIN_STEPS, "epoch": 0})
            shutil.copytree(os.path.join(d, "0"), os.path.join(out, name, "0"))
            record["checkpoints"][name] = leaf_digests(jck._restore_numpy(os.path.join(d, "0")))
            rgb, acc = jax_render(cfg_j, st.params, batch)
            expected[f"{name}_rgb"], expected[f"{name}_acc"] = rgb, acc
        for kind, arr in corpus_arrays().items():
            for level in LEVELS:
                frame = ts_write_chunk(tmp, arr, level)
                fname = f"{kind}_l{level}.zst"
                with open(os.path.join(out, "corpus", fname), "wb") as f:
                    f.write(frame)
                record["corpus"][fname] = {"sha256": sha(arr), "size": arr.nbytes,
                                           "level": level, "kind": kind}
    np.savez(os.path.join(out, "expected.npz"), **expected)
    with open(os.path.join(out, "digests.json"), "w") as f:
        json.dump(record, f, indent=1, sort_keys=True)
        f.write("\n")


# -- zstd ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", corpus_names())
def test_corpus_frame_decodes_to_its_digest_and_tensorstore(name, tmp_path):
    rec = digests()["corpus"][name]
    with open(os.path.join(FIX, "corpus", name), "rb") as f:
        frame = f.read()
    assert orbax_format.content_size(frame) in (None, rec["size"])
    got = decode(frame, rec["size"])
    assert hashlib.sha256(got).hexdigest() == rec["sha256"]
    assert got == ts_decode(str(tmp_path), frame, rec["size"])
    assert orbax_format.decompress(frame) == got


@pytest.mark.parametrize("level", [-3, 2, 5, 7, 12, 16, 20, 22])
def test_frames_tensorstore_writes_now_decode(level, tmp_path):
    """More levels and data kinds: int32/int64 data, a 4-letter alphabet
    (directly coded Huffman weights), pieces of one random base (repeat
    offsets and repeated tables over a frame of several blocks)."""
    rng = np.random.default_rng(level + 10)
    base = rng.integers(0, 255, 4096).astype(np.uint8)
    pieces = [base]
    for _ in range(8000):
        o = int(rng.integers(0, 4000))
        pieces += [np.array([255], np.uint8), base[o:o + int(rng.integers(8, 64))]]
    arrays = list(corpus_arrays().values()) + [
        rng.integers(-1000, 1000, 50000).astype(np.int32),
        np.arange(30000, dtype=np.int64) // 7,
        (np.sin(np.arange(70000) / 50.0) * 100).astype(np.float32),
        rng.standard_normal((3, 5, 7)).astype(np.float32),
        rng.integers(0, 4, 20000).astype(np.uint8), np.concatenate(pieces)]
    for arr in arrays:
        frame = ts_write_chunk(str(tmp_path), arr, level)
        assert decode(frame, arr.nbytes) == arr.tobytes(), (arr.dtype, arr.size)


def xxh64_plain(data: bytes, seed: int = 0) -> int:
    """XXH64 as its specification states it, in plain Python."""
    M = (1 << 64) - 1
    P1, P2, P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
    P4, P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5

    def rotl(x, r):
        return ((x << r) | (x >> (64 - r))) & M

    def rnd(acc, lane):
        return rotl((acc + lane * P2) & M, 31) * P1 & M

    n, p = len(data), 0
    if n >= 32:
        v = [(seed + P1 + P2) & M, (seed + P2) & M, seed, (seed - P1) & M]
        while n - p >= 32:
            for i in range(4):
                v[i] = rnd(v[i], int.from_bytes(data[p + 8 * i:p + 8 * i + 8], "little"))
            p += 32
        h = (rotl(v[0], 1) + rotl(v[1], 7) + rotl(v[2], 12) + rotl(v[3], 18)) & M
        for x in v:
            h = ((h ^ rnd(0, x)) * P1 + P4) & M
    else:
        h = (seed + P5) & M
    h = (h + n) & M
    while n - p >= 8:
        h ^= rnd(0, int.from_bytes(data[p:p + 8], "little"))
        h = (rotl(h, 27) * P1 + P4) & M
        p += 8
    if n - p >= 4:
        h ^= int.from_bytes(data[p:p + 4], "little") * P1 & M
        h = (rotl(h, 23) * P2 + P3) & M
        p += 4
    while p < n:
        h ^= data[p] * P5 & M
        h = rotl(h, 11) * P1 & M
        p += 1
    h ^= h >> 33
    h = h * P2 & M
    h ^= h >> 29
    h = h * P3 & M
    return h ^ (h >> 32)


def crc32c_plain(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c ^= b
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
    return c ^ 0xFFFFFFFF


def test_xxh64_and_crc32c_against_plain_python():
    assert xxh64_plain(b"") == 0xEF46DB3751D8E999
    assert orbax_format.xxh64(b"") == 0xEF46DB3751D8E999
    rng = np.random.default_rng(0)
    for n in (1, 3, 4, 7, 8, 31, 32, 33, 63, 100, 1000):
        data = rng.bytes(n)
        for seed in (0, 12345):
            assert orbax_format.xxh64(data, seed) == xxh64_plain(data, seed), (n, seed)
    assert crc32c_plain(b"123456789") == 0xE3069283
    assert orbax_format.crc32c(b"123456789") == 0xE3069283
    for n in (0, 1, 7, 8, 9, 64, 1001):
        data = rng.bytes(n)
        assert orbax_format.crc32c(data) == crc32c_plain(data), n


def checksum_frame(data: bytes) -> bytes:
    """A frame of raw and RLE blocks with the content-checksum flag set and
    the low 32 bits of XXH64 after the last block."""
    frame = bytearray(b"".join(make_fixtures.zstd_frame(data)))
    frame[4] |= 4
    return bytes(frame) + (xxh64_plain(data) & 0xFFFFFFFF).to_bytes(4, "little")


def test_content_checksum_is_verified():
    data = np.repeat(np.arange(300, dtype=np.uint8), 700).tobytes() + b"tail"
    frame = checksum_frame(data)
    assert decode(frame, len(data)) == data
    bad = bytearray(frame)
    bad[-2] ^= 0x10
    with pytest.raises(ValueError, match="checksum mismatch"):
        decode(bytes(bad), len(data))
    bad = bytearray(frame)
    bad[20] ^= 0x01                           # a content byte of a raw block
    with pytest.raises(ValueError, match="checksum mismatch"):
        decode(bytes(bad), len(data))


def test_hand_built_literal_sections():
    """Compressed blocks of literals only (no sequences): RLE literals, raw
    literals with 1-, 2- and 3-byte section headers."""
    def frame(block: bytes) -> bytes:
        head = (1 | 2 << 1 | len(block) << 3).to_bytes(3, "little")     # last, compressed
        # no content size; a 1 KiB window
        return orbax_format.ZSTD_MAGIC.to_bytes(4, "little") + bytes([0, 0]) + head + block
    rle = bytes([1 | 20 << 3, ord("Q"), 0])                # RLE, 5-bit size, 0 sequences
    assert decode(frame(rle), 20) == b"Q" * 20
    for size, head in ((17, bytes([17 << 3])),
                       (100, bytes([1 << 2 | (100 & 15) << 4, 100 >> 4])),
                       (200, bytes([3 << 2 | (200 & 15) << 4, (200 >> 4) & 255, 200 >> 12]))):
        data = bytes(range(size))
        assert decode(frame(head + data + b"\0"), size) == data


def test_concatenated_skippable_and_unsized_frames():
    a, b = b"first frame " * 50, bytes(200000)
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") + b"12345"
    blob = b"".join(make_fixtures.zstd_frame(a)) + skip + b"".join(make_fixtures.zstd_frame(b))
    assert orbax_format.decompress(blob) == a + b
    # a frame that states no content size (no single segment, no FCS)
    frame = bytearray(b"".join(make_fixtures.zstd_frame(a)))
    unsized = bytes(frame[:4]) + bytes([0x00, 0x58]) + bytes(frame[13:])   # window 2^21
    assert orbax_format.content_size(unsized) is None
    assert orbax_format.decompress(unsized) == a


@pytest.mark.parametrize("case,match", [
    ("dictionary", "dictionary 7"), ("magic", "bad magic"), ("reserved_block", "reserved block"),
    ("truncated", "truncated"), ("trailing", "trailing bytes"), ("overflow", "exceed")])
def test_malformed_frames_raise_naming_the_fault(case, match):
    data = np.arange(5000, dtype=np.uint16).tobytes()
    frame = bytearray(b"".join(make_fixtures.zstd_frame(data)))
    cap = len(data)
    if case == "dictionary":      # FHD dictionary flag 1, one ID byte
        frame = frame[:4] + bytes([frame[4] | 1, 7]) + frame[5:]
    elif case == "magic":
        frame[0] ^= 1
    elif case == "reserved_block":
        frame[13] |= 6
    elif case == "truncated":
        frame = frame[:-100]
    elif case == "trailing":
        frame += b"\x00\x01"
    else:
        cap = len(data) - 1
    with pytest.raises(ValueError, match=match):
        orbax_format.decompress_into(bytes(frame), np.empty(cap, np.uint8), "the frame")
    with pytest.raises(ValueError, match="the frame"):
        orbax_format.decompress_into(bytes(frame), np.empty(cap, np.uint8), "the frame")


def damaged_copies():
    """(label, bytes, decoded size) of damaged corpus frames and OCDBT
    nodes and manifests of a committed checkpoint (size -1)."""
    rng = np.random.default_rng(5)
    out = []
    sources = []
    for name in corpus_names()[::2]:
        with open(os.path.join(FIX, "corpus", name), "rb") as f:
            sources.append((name, f.read(), digests()["corpus"][name]["size"]))
    ck = os.path.join(FIX, "adam_f32", "0")
    for rel in ("manifest.ocdbt", os.path.join("d", os.listdir(os.path.join(ck, "d"))[0])):
        with open(os.path.join(ck, rel), "rb") as f:
            sources.append((rel, f.read(), -1))
    for name, data, size in sources:
        n = len(data)
        for i in range(40):                          # bit flips
            d = bytearray(data)
            for _ in range(1 + i % 3):
                pos = int(rng.integers(0, n))
                d[pos] ^= 1 << int(rng.integers(0, 8))
            out.append((f"{name}:flip{i}", bytes(d), size))
        for i in range(12):                          # header bytes
            d = bytearray(data)
            d[int(rng.integers(0, min(n, 24)))] = int(rng.integers(0, 256))
            out.append((f"{name}:head{i}", bytes(d), size))
        for cut in sorted(set(int(c) for c in rng.integers(0, n, 8))) + [n - 1]:
            out.append((f"{name}:cut{cut}", data[:cut], size))
    return out


DECODE_ALL = r"""
import sys, pickle
import numpy as np
from instant_nvr_tpu_torch.train import orbax_format
copies = pickle.load(open(sys.argv[1], "rb"))
ok = refused = 0
for label, data, size in copies:
    try:
        if size < 0:
            magic = orbax_format.MANIFEST_MAGIC if "manifest" in label else orbax_format.NODE_MAGIC
            orbax_format._unwrap(data, magic, label)
        else:
            orbax_format.decompress_into(data, np.empty(size, np.uint8), label)
            orbax_format.decompress(data, label)
        ok += 1
    except ValueError as e:
        assert label in str(e), (label, str(e))
        refused += 1
print(ok, refused)
"""


def test_damaged_frames_and_nodes_decode_or_raise(tmp_path):
    """In a subprocess, so that a crash fails the test and not the run:
    every damaged copy decodes or raises ValueError naming it; every
    damaged node or manifest raises (its CRC32C)."""
    import pickle
    copies = damaged_copies()
    nodes = [c for c in copies if c[2] < 0]
    for path, items in (("all.pkl", copies), ("nodes.pkl", nodes)):
        with open(tmp_path / path, "wb") as f:
            pickle.dump(items, f)
    for path, want_ok in (("all.pkl", None), ("nodes.pkl", 0)):
        res = subprocess.run([sys.executable, "-c", DECODE_ALL, str(tmp_path / path)],
                             capture_output=True, text=True, cwd=ROOT, timeout=300)
        assert res.returncode == 0, (res.stdout[-2000:], res.stderr[-4000:])
        ok, refused = map(int, res.stdout.split())
        n = len(copies if path == "all.pkl" else nodes)
        assert ok + refused == n and refused > n // 2
        if want_ok is not None:
            assert ok == want_ok


HARNESS = r"""
#include <fstream>
#include <iterator>
#include <sstream>
#include "SOURCE"
int main(int argc, char** argv) {
  std::ifstream bf(argv[1], std::ios::binary);
  std::vector<char> blob((std::istreambuf_iterator<char>(bf)), std::istreambuf_iterator<char>());
  std::ifstream index(argv[2]);
  std::string line;
  int ok = 0, refused = 0;
  char err[512];
  while (std::getline(index, line)) {
    std::istringstream in(line);
    size_t off, n;
    long long size;
    in >> off >> n >> size;
    // a copy of exactly its bytes, so that a read past its end is caught
    std::vector<uint8_t> data(blob.begin() + off, blob.begin() + off + n);
    crc32c(data.data(), int64_t(n));
    xxh64(data.data(), int64_t(n), 0);
    int64_t stated = zstd_content_size(data.data(), int64_t(n), err, sizeof err);
    int64_t cap = size >= 0 ? size : (stated >= 0 && stated < (1 << 26) ? stated : (1 << 20));
    std::vector<uint8_t> out(static_cast<size_t>(cap));
    if (zstd_decompress(data.data(), int64_t(n), out.data(), cap, err, sizeof err) < 0) refused++;
    else ok++;
  }
  printf("%d %d\n", ok, refused);
  return 0;
}
"""


def test_damaged_copies_under_address_and_bounds_sanitizers(tmp_path):
    """The library's source built with AddressSanitizer and UBSan over the
    same damaged copies (a node's zstd body too): no read or write out of
    bounds, no undefined behaviour (the process aborts on the first)."""
    (tmp_path / "harness.cpp").write_text(HARNESS.replace("SOURCE", str(orbax_format.SOURCE)))
    exe = tmp_path / "harness"
    cmd = ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
           "-fno-sanitize-recover=all", "-o", str(exe), str(tmp_path / "harness.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    copies = [(lbl, d, s) for lbl, d, s in damaged_copies()]
    # the zstd bodies of damaged nodes: from byte 14 (magic, length, 2 varints)
    copies += [(lbl + ":body", d[14:-4], -1) for lbl, d, s in copies if s < 0]
    with open(tmp_path / "blob", "wb") as f, open(tmp_path / "index", "w") as idx:
        off = 0
        for _, d, s in copies:
            f.write(d)
            idx.write(f"{off} {len(d)} {s}\n")
            off += len(d)
    res = subprocess.run([str(exe), str(tmp_path / "blob"), str(tmp_path / "index")],
                         capture_output=True, text=True, timeout=300,
                         env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0, (res.returncode, res.stderr[-4000:])
    ok, refused = map(int, res.stdout.split())
    assert ok + refused == len(copies) and refused > 0


# -- the reader against orbax and tensorstore -----------------------------------------

@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_reader_matches_orbax(variant, tmp_path):
    """A JAX checkpoint of each optimizer configuration, its state filled
    with seeded values: every leaf as orbax's _restore_numpy gives it."""
    cfg_j, _ = tiny_cfg(VARIANTS[variant])
    _, _, st = jax_state(cfg_j, fill=np.random.default_rng(1))
    jck.save_checkpoint(str(tmp_path), 4, st, {"step": 7, "epoch": 4})
    for tag in ("4", "latest"):
        path = str(tmp_path / tag)
        assert_trees_equal(orbax_format.read_checkpoint(path, None),
                           jck._restore_numpy(path), f"{variant}/{tag}")


TWO_PROCESS = r"""
import sys
import numpy as np
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_cpu_collectives_implementation", "gloo")
pid, port, path = int(sys.argv[1]), sys.argv[2], sys.argv[3]
jax.distributed.initialize(f"localhost:{port}", num_processes=2, process_id=pid)
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P
import orbax.checkpoint as ocp
mesh = Mesh(np.array(jax.devices()), ("x",))
w = np.random.default_rng(0).standard_normal((40 * len(jax.devices()), 64)).astype(np.float32)
arr = jax.make_array_from_callback(w.shape, NamedSharding(mesh, P("x")), lambda i: w[i])
rep = jax.make_array_from_callback((5,), NamedSharding(mesh, P()),
                                   lambda i: np.arange(5, dtype=np.int32)[i])
ck = ocp.StandardCheckpointer()
ck.save(path, {"params": {"w": arr, "r": rep}, "step": np.asarray(3, np.int32)})
ck.wait_until_finished()
print("saved")
"""


def test_two_process_checkpoint_matches_orbax(tmp_path):
    """A checkpoint orbax writes from two CPU processes (jax.distributed,
    Gloo): an array sharded over the devices of both, its chunks in each
    process's own OCDBT database, read as orbax reads it."""
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = str(s.getsockname()[1])
    path = str(tmp_path / "0")
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    procs = [subprocess.Popen([sys.executable, "-c", TWO_PROCESS, str(i), port, path],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
             for i in range(2)]
    outs = [p.communicate(timeout=240) for p in procs]
    assert all(p.returncode == 0 for p in procs), [o[1][-2000:] for o in outs]
    store = orbax_format.OcdbtStore(path)
    chunks = [k for k in store.keys() if k.startswith(b"params.w/") and b".zarray" not in k]
    assert len(chunks) >= 2 and len(chunks) % 2 == 0      # a row block per device
    files = {v[0].split("/")[0] for v in store.entries.values()
             if isinstance(v, orbax_format.ValueRef)}
    assert files == {"ocdbt.process_0", "ocdbt.process_1"}
    assert_trees_equal(orbax_format.read_checkpoint(path, None), jck._restore_numpy(path))


@pytest.mark.parametrize("name", sorted(CKPTS))
def test_committed_checkpoints_match_orbax_and_digests(name):
    path = os.path.join(FIX, name, "0")
    tree = orbax_format.read_checkpoint(path, None)
    assert_trees_equal(tree, jck._restore_numpy(path), name)
    assert leaf_digests(tree) == digests()["checkpoints"][name]
    mu = tree["opt_state"][0]["mu"]["embed"]["body"]["hash"]
    assert isinstance(mu, torch.Tensor) == (name == "adam_bf16")
    assert int(tree["step"]) == TRAIN_STEPS == int(tree["opt_state"][0]["count"])


def test_latest_and_garbage_collected_epochs(tmp_path, monkeypatch):
    """Epochs 0-4 with at most 2 kept: the port resolves latest, the kept
    epochs and the newest as the JAX package does, and reads each as orbax."""
    monkeypatch.setattr(jck, "MAX_KEPT", 2)
    cfg_j, cfg = tiny_cfg()
    d = str(tmp_path / "model")
    for epoch in range(5):
        _, _, st = jax_state(cfg_j, seed=epoch)
        jck.save_checkpoint(d, epoch, st, {"step": epoch, "epoch": epoch})
    assert sorted(os.listdir(d)) == ["3", "4", "latest"]
    for epoch, want in ((None, "latest"), (-1, "latest"), (3, "3"), (4, "4")):
        path = checkpoint._find(d, epoch)
        assert path == os.path.join(d, want)
        tree = orbax_format.read_checkpoint(path, None)
        assert_trees_equal(tree, jck._restore_numpy(path), want)
    shutil.rmtree(os.path.join(d, "latest"))
    assert checkpoint._find(d) == os.path.join(d, "4")
    # the port reads what JAX's load_weights reads
    _, _, model = build(cfg, CPU)
    checkpoint.load_weights(d, model, 3)
    jparams = jck.load_weights(d, jinb.init_params(jax.random.key(9), jinb.build_model_spec(cfg_j)), 3)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jparams), model.spec)
    for k, v in model.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_only_params_are_read_for_weights(tmp_path, monkeypatch):
    path = os.path.join(FIX, "adam_f32", "0")
    read = []
    orig = orbax_format.OcdbtStore.read

    def spy(self, key):
        read.append(key.decode())
        return orig(self, key)

    monkeypatch.setattr(orbax_format.OcdbtStore, "read", spy)
    tree = orbax_format.read_checkpoint(path, ("params",))
    assert set(tree) == {"params"} and read
    assert all(k.startswith("params.") for k in read), [k for k in read if not k.startswith("params.")]
    _, cfg = tiny_cfg()
    read.clear()
    _, _, model = build(cfg, CPU)
    checkpoint.load_weights(os.path.dirname(path), model)
    assert read and all(k.startswith("params.") for k in read)


def test_interior_nodes_and_inline_values_match_tensorstore(tmp_path):
    """An OCDBT store with small nodes (a B-tree of several levels, key
    prefixes at every level) and both inline and out-of-line values."""
    rng = np.random.default_rng(2)
    kv = ts.KvStore.open({"driver": "ocdbt", "base": f"file://{tmp_path}/",
                          "config": {"max_decoded_node_bytes": 300,
                                     "max_inline_value_bytes": 16}}).result()
    with ts.Transaction() as txn:
        for i in range(300):
            key = (f"opt_state.{i % 3}.mu/{i:05d}" if i % 2 else f"params.x{i}/.zarray").encode()
            kv.with_transaction(txn)[key] = rng.bytes(int(rng.integers(0, 60)))
    store = orbax_format.OcdbtStore(str(tmp_path))
    keys = kv.list().result()
    assert store.keys() == sorted(keys) and len(keys) == 300
    for k in keys:
        assert store.read(k) == kv.read(k).result().value
    kinds = {type(v) for v in store.entries.values()}
    assert kinds == {bytes, orbax_format.ValueRef}


def test_multichunk_uncompressed_and_missing_chunks(tmp_path):
    rng = np.random.default_rng(3)
    arrays = {"a": (rng.standard_normal((37, 23)).astype(np.float32), [8, 10], "zstd"),
              "b": (rng.integers(-5, 5, (10, 7, 3)).astype(np.int64), [3, 7, 2], "zstd"),
              "c": (rng.integers(0, 100, (1000,)).astype(np.int32), [300], None),
              "d": (np.zeros((6, 4), np.float32), [2, 4], "zstd")}
    for k, (a, chunks, comp) in arrays.items():
        meta = {"shape": list(a.shape), "chunks": chunks, "dtype": a.dtype.str,
                "compressor": {"id": comp, "level": 3} if comp else None}
        if k == "d":
            meta["fill_value"] = 0.0     # all-fill chunks are not stored
        t = ts.open({"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{tmp_path}/",
                                                   "path": k + "/"}, "metadata": meta},
                    create=True).result()
        t.write(a).result()
    store = orbax_format.OcdbtStore(str(tmp_path))
    for k, (a, _, _) in arrays.items():
        got = orbax_format.read_array(store, k)
        assert got.dtype == a.dtype and np.array_equal(got, a), k
    assert not any(k.startswith(b"d/0") for k in store.keys())


@pytest.mark.parametrize("field,value,match", [
    ("dtype", "<f8", "dtype '<f8'"), ("order", "F", "order 'F'"),
    ("compressor", {"id": "blosc"}, "compressor"), ("zarr_format", 3, "zarr_format 3")])
def test_unsupported_arrays_are_refused_naming_the_leaf(field, value, match, tmp_path):
    path = str(tmp_path / "0")
    make_fixtures.write_orbax_checkpoint(path, {"params": {"w": np.ones(3, np.float32)}})
    store = orbax_format.OcdbtStore(path)
    meta = json.loads(store.read(b"params.w/.zarray"))
    meta[field] = value
    store.entries[b"params.w/.zarray"] = json.dumps(meta).encode()
    with pytest.raises(ValueError, match=f"leaf params.w.*{match}"):
        orbax_format.read_array(store, "params.w")


# -- the model ------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(CKPTS))
def test_committed_checkpoint_renders_as_jax(name):
    """The port's render of the committed checkpoint (load_weights, CPU)
    against JAX's, committed in expected.npz and recomputed here."""
    cfg_j, cfg = tiny_cfg(CKPTS[name])
    exp = np.load(os.path.join(FIX, "expected.npz"))
    batch = scene_batch()
    for k in ("ray_o", "ray_d", "near", "far"):
        assert np.array_equal(batch[k], exp[k]), k
    model_dir = os.path.join(FIX, name)
    mspec, rspec, model = build(cfg, CPU)
    checkpoint.load_weights(model_dir, model)
    with torch.no_grad():
        got = rend.render_rays(mspec, rspec, model,
                               {k: torch.as_tensor(np.asarray(v)) for k, v in batch.items()})
    jparams = jck.load_weights(model_dir, jinb.init_params(jax.random.key(5), jinb.build_model_spec(cfg_j)))
    rgb, acc = jax_render(cfg_j, jparams, batch)
    np.testing.assert_array_equal(rgb, exp[f"{name}_rgb"])
    np.testing.assert_array_equal(acc, exp[f"{name}_acc"])
    assert np.abs(rgb).max() > 0.01 and np.isfinite(rgb).all()
    np.testing.assert_allclose(got["rgb_map"].numpy(), rgb, rtol=0, atol=1e-3)
    np.testing.assert_allclose(got["acc_map"].numpy(), acc, rtol=0, atol=1e-3)


def _draws(cfg_j, mspec, rspec, batch_np, rng):
    """JAX render_rays' draws for key ``rng``, for the port's draws=."""
    R, S = batch_np["ray_o"].shape[0], rspec.n_samples
    k_strat, k_pair = jax.random.split(rng)
    B = rend.pair_budget(mspec, rspec, R * S)
    noise = (jax.random.uniform(k_pair, (B, 3), jnp.float32) - 0.5) \
        * jrend.make_render_spec(cfg_j).pair_range
    return {"t_rand": torch.from_numpy(np.array(jax.random.uniform(k_strat, (R, S), jnp.float32))),
            "pair_noise": torch.from_numpy(np.array(noise))}


def _close(got, want, what, rtol=1e-4, atol=0.0):
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=1e-6 * scale + atol, err_msg=what)


@pytest.mark.parametrize("moments", ["float32", "bfloat16"])
def test_resumed_step_matches_jax(moments, tmp_path):
    """2 JAX steps, saved; then one more step in the JAX package (resumed by
    its load_checkpoint) and in the port (resumed by its load_checkpoint
    from the same directory), float32 mode.  With a bfloat16 first moment
    the two steps' gradients, equal to float32 rounding, can round a
    moment entry to neighbouring bf16 values: the moment then differs by a
    bf16 ulp (2^-8 of it, 2^-7 allowed) and the parameter by up to that
    share of the step (lr x 2^-7 allowed).  Where the gradient term
    cancels b1 x mu16 (rounded to bf16 on both sides, 2^-9 of the product),
    a small entry keeps that rounding as its own error: within 2^-8 of the
    leaf's largest moment."""
    cfg_j, cfg = tiny_cfg({"train": {"moment_dtype": moments}}, F32_MODE)
    batch_np = tiny_batch()
    mspec_j, opt, st = jax_train(cfg_j, 2, batch_np)
    d = str(tmp_path / "model")
    jck.save_checkpoint(d, 0, st, {"step": 2, "epoch": 0})
    jtemplate = jstate.create_train_state(jinb.init_params(jax.random.key(3), mspec_j), opt, mspec_j)
    jresumed, jmeta = jck.load_checkpoint(d, jtemplate)
    step = jax.jit(jstep.make_train_step(mspec_j, jrend.make_render_spec(cfg_j),
                                         jstep.make_loss_weights(cfg_j), opt))
    jnext, jstats = step(jresumed, {k: jnp.asarray(v) for k, v in batch_np.items()},
                         jax.random.key(2))

    mspec, rspec, model = build(cfg, CPU, seed=4)
    state = tstate.create_train_state(cfg, model)
    meta = checkpoint.load_checkpoint(d, state)
    assert meta == {"epoch": 0, "step": 2} == {k: int(v) for k, v in jmeta.items()}
    assert state.step == 2
    adam = state.optimizer
    first = adam.state[model.embed["body"].hash]
    assert first["exp_avg"].dtype == (torch.bfloat16 if moments == "bfloat16" else torch.float32)
    mu_j = np.asarray(st.opt_state[0].mu["embed"]["body"]["hash"].astype(jnp.float32))
    assert np.array_equal(first["exp_avg"].float().numpy(), mu_j[:model.embed["body"].hash.shape[0]])
    _, stats = tstep.make_train_step(mspec, rspec, tstep.make_loss_weights(cfg))(
        state, {k: torch.as_tensor(np.asarray(v)) for k, v in batch_np.items()},
        draws=_draws(cfg_j, mspec, rspec, batch_np, jax.random.key(2)))
    assert state.step == 3 == int(jnext.step)
    for k in ("loss", "img_loss", "psnr"):
        np.testing.assert_allclose(stats[k].numpy(), np.asarray(jstats[k]), rtol=1e-5,
                                   atol=1e-7, err_msg=k)
    want = bridge.params_from_jax(jax.tree.map(np.asarray, jnext.params), mspec)
    bf16 = moments == "bfloat16"
    lr = cfg.train.lr
    for k, v in model.state_dict().items():
        _close(v.numpy(), want[k].numpy(), f"param {k}", atol=2.0 ** -7 * lr if bf16 else 0.0)
    mu_next = bridge.params_from_jax(jax.tree.map(lambda x: np.asarray(x, np.float32),
                                                  jnext.opt_state[0].mu), mspec)
    names = {id(p): n for n, p in model.named_parameters()}
    for p, s in adam.state.items():
        want_mu = mu_next[names[id(p)]].numpy()
        _close(s["exp_avg"].float().numpy(), want_mu, "mu " + names[id(p)],
               rtol=2.0 ** -7 if bf16 else 1e-4,
               atol=2.0 ** -8 * float(np.abs(want_mu).max()) if bf16 else 0.0)


def _eval_setup(base):
    """A tiny fake subject and its YAML (tests/test_torch_eval.py's), and a
    JAX-written checkpoint of seeded weights."""
    import yaml
    from instant_nvr_tpu.config import make_cfg as jmake_cfg
    from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
    from test_torch_eval import tiny_overrides
    root = os.path.join(base, "zju")
    write_fake_dataset(root, n_frames=2, n_views=2, H=64, W=64)
    path = os.path.join(base, "cfg.yaml")
    with open(path, "w") as f:
        yaml.safe_dump(tiny_overrides(root), f)
    cfg_j = jmake_cfg(path, ["trained_model_dir", os.path.join(base, "jmodel")])
    _, _, st = jax_state(cfg_j, seed=11)
    jck.save_checkpoint(os.path.join(base, "jmodel"), 3, st, {"step": 30, "epoch": 3})
    return path


def test_run_evaluate_on_a_jax_directory_matches_jax(tmp_path):
    """``run --type evaluate`` of the JAX package and of the port, each on
    its own copy of the JAX-written directory (weights of key 11, not the
    key-0 init either falls back to)."""
    import io
    from contextlib import redirect_stdout

    import run as jrun
    from instant_nvr_tpu.config import make_cfg as jmake_cfg
    from instant_nvr_tpu_torch import run
    from test_torch_eval import _check_metrics, _metrics
    yml = _eval_setup(str(tmp_path))
    out = {}
    for who in ("j", "t"):
        model = str(tmp_path / who / "model")
        shutil.copytree(str(tmp_path / "jmodel"), model)
        opts = ["result_dir", str(tmp_path / who / "res"), "trained_model_dir", model]
        cfg_j = jmake_cfg(yml, opts)
        if who == "j":
            jrun.run_evaluate(cfg_j)
        else:
            buf = io.StringIO()
            with redirect_stdout(buf):
                run.main(["--cfg_file", yml, "--type", "evaluate", "--device", "cpu"] + opts)
            assert "loaded weights from" in buf.getvalue()
        out[who] = _metrics(cfg_j.result_dir)
    _check_metrics(out["t"], out["j"])


def test_train_net_resumes_from_a_jax_directory(tmp_path):
    """The loop resumes a JAX-written directory: the epoch after its meta's,
    the saved step, then writes its own state.pt beside it."""
    from instant_nvr_tpu_torch import train_net
    from instant_nvr_tpu_torch.config import make_cfg
    from instant_nvr_tpu_torch.datasets.fake_zju import write_fake_dataset
    from instant_nvr_tpu_torch.train import loop
    from instant_nvr_tpu.config import Config as JConfig
    root = str(tmp_path / "subject")
    write_fake_dataset(root, n_frames=2, n_views=2, H=64, W=64, supersample=1)
    data = {"data_root": root, "ann_file": os.path.join(root, "annots.npy")}
    exp = str(tmp_path / "exp")
    cfg = make_cfg(os.path.join(ROOT, "configs/inb/inb_fake.yaml")).merged(train_net.TINY).merged({
        "train_dataset": data, "smpl_meta": os.path.join(root, "smpl-meta"),
        "num_train_frame": 2, "num_latent_code": 2, "training_view": [0, 1], "test_view": [],
        "ep_iter": 2, "train": {"epoch": 3}, "result_dir": exp,
        "trained_model_dir": exp + "/model", "record_dir": exp + "/rec"})
    cfg_j = JConfig(cfg.to_dict())
    _, _, st = jax_state(cfg_j, fill=np.random.default_rng(4))
    st = st._replace(step=jnp.asarray(4, jnp.int32),
                     opt_state=(st.opt_state[0]._replace(count=jnp.asarray(4, jnp.int32)),
                                st.opt_state[1]))
    jck.save_checkpoint(cfg.trained_model_dir, 1, st, {"step": 4, "epoch": 1})
    res = loop.train(cfg, CPU, resume=True)
    assert [e.epoch for e in res.epochs] == [2] and res.state.step == 6
    assert np.isfinite(res.losses).all() and len(res.losses) == 2
    assert checkpoint.layout(os.path.join(cfg.trained_model_dir, "2")) == "torch"
    assert checkpoint.layout(os.path.join(cfg.trained_model_dir, "1")) == "orbax"


# -- the converter, the writer, refusals ---------------------------------------------------

def test_import_jax_ckpt_output_loads_bit_for_bit(tmp_path):
    src = os.path.join(FIX, "adam_bf16")
    out = str(tmp_path / "port")
    yml = tiny_yaml(tmp_path, CKPTS["adam_bf16"])
    _, cfg = tiny_cfg(CKPTS["adam_bf16"])
    import_jax_ckpt.main(["--cfg_file", yml, "--src", src, "--out", out, "--device", "cpu"])
    assert sorted(os.listdir(out)) == ["0", "latest"]
    states = []
    for d in (src, out):
        _, _, model = build(cfg, CPU, seed=1)
        st = tstate.create_train_state(cfg, model)
        meta = checkpoint.load_checkpoint(d, st)
        states.append((st, meta))
    (a, ma), (b, mb) = states
    assert ma == mb == {"epoch": 0, "step": TRAIN_STEPS} and a.step == b.step == TRAIN_STEPS
    for k, v in a.model.state_dict().items():
        assert torch.equal(v, b.model.state_dict()[k]), k
    sa, sb = a.optimizer.state_dict(), b.optimizer.state_dict()
    assert sa["state"].keys() == sb["state"].keys()
    for i in sa["state"]:
        for k, v in sa["state"][i].items():
            w = sb["state"][i][k]
            assert (torch.equal(v, w) and v.dtype == w.dtype) if torch.is_tensor(v) else v == w
    with pytest.raises(RuntimeError, match="torch.cuda is not available"):
        import_jax_ckpt.main(["--cfg_file", yml, "--src", src, "--out", out])


def _host(x):
    """A jax leaf as the writer takes it: numpy, or a bf16 torch tensor."""
    x = np.array(x)
    return torch.from_numpy(x.view(np.uint16)).view(torch.bfloat16) \
        if x.dtype.name == "bfloat16" else x


def _host_tree(st, epoch, step):
    return {"params": jax.tree.map(_host, st.params),
            "opt_state": [{k: jax.tree.map(_host, v) for k, v in s._asdict().items()}
                          for s in st.opt_state],
            "step": np.asarray(st.step),
            "meta": {"epoch": np.asarray(epoch, np.int64), "step": np.asarray(step, np.int64)}}


def test_writer_is_read_by_orbax_and_jax_load_checkpoint(tmp_path):
    """A tree with bfloat16 moments written by the port's writer: orbax
    restores it leaf for leaf and the JAX package's load_checkpoint
    accepts it into its template."""
    cfg_j, _ = tiny_cfg(CKPTS["adam_bf16"])
    mspec, opt, st = jax_state(cfg_j, fill=np.random.default_rng(6))
    tree = _host_tree(st, 5, 70)
    path = str(tmp_path / "model" / "5")
    make_fixtures.write_orbax_checkpoint(path, tree)
    restored = jck._restore_numpy(path)
    assert_trees_equal(orbax_format.read_checkpoint(path, None), restored)
    assert_trees_equal(tree, restored)
    new, meta = jck.load_checkpoint(str(tmp_path / "model"), st._replace(step=jnp.zeros((), jnp.int32)))
    assert new is not None and {k: int(v) for k, v in meta.items()} == {"epoch": 5, "step": 70}
    assert int(new.step) == int(st.step)
    for a, b in zip(jax.tree.leaves(new.opt_state), jax.tree.leaves(st.opt_state)):
        assert a.dtype == b.dtype and np.array_equal(np.asarray(a), np.asarray(b))


def test_padding_rows_are_checked_and_dropped(tmp_path):
    """Tables, and their moments, with zero rows past their logical rows
    (the JAX package's tile padding at full width) load as the unpadded
    state; a non-zero padding row raises naming the leaf."""
    cfg_j, cfg = tiny_cfg()
    _, _, st = jax_state(cfg_j, fill=np.random.default_rng(7))
    tree = _host_tree(st, 2, 9)

    def pad(t):
        for part in list(t["embed"].values()) + [t["deformer"]["embed"]]:
            for k in ("dense", "hash"):
                part[k] = np.concatenate([part[k], np.zeros((5,) + part[k].shape[1:], np.float32)])
    for t in (tree["params"], tree["opt_state"][0]["mu"], tree["opt_state"][0]["nu"]):
        pad(t)
    make_fixtures.write_orbax_checkpoint(str(tmp_path / "a" / "2"), tree)
    plain = _host_tree(st, 2, 9)
    make_fixtures.write_orbax_checkpoint(str(tmp_path / "b" / "2"), plain)
    states = []
    for d in ("a", "b"):
        _, _, model = build(cfg, CPU, seed=1)
        state = tstate.create_train_state(cfg, model)
        assert checkpoint.load_checkpoint(str(tmp_path / d), state) == {"epoch": 2, "step": 9}
        states.append(state)
    for k, v in states[0].model.state_dict().items():
        assert torch.equal(v, states[1].model.state_dict()[k]), k
    for p, q in zip(states[0].model.parameters(), states[1].model.parameters()):
        a, b = states[0].optimizer.state[p], states[1].optimizer.state[q]
        assert all(torch.equal(a[k], b[k]) for k in ("step", "exp_avg", "exp_avg_sq"))
    tree["opt_state"][0]["nu"]["embed"]["leg"]["hash"][-1] = 1.0
    make_fixtures.write_orbax_checkpoint(str(tmp_path / "c" / "2"), tree)
    _, _, model = build(cfg, CPU)
    with pytest.raises(ValueError, match=r"opt_state\.0\.nu: .*embed\.leg\.hash: padding rows"):
        checkpoint.load_checkpoint(str(tmp_path / "c"), tstate.create_train_state(cfg, model))


def test_unmappable_states_raise_naming_the_path(tmp_path):
    _, cfg = tiny_cfg()
    path = os.path.join(FIX, "adam_f32", "0")
    tree = orbax_format.read_checkpoint(path, None)
    _, _, model = build(cfg, CPU)
    opt = tstate.create_train_state(cfg, model).optimizer
    odd = [tree["opt_state"][0], {"count": tree["step"], "extra": tree["step"]}]
    with pytest.raises(ValueError, match=r"opt_state\.1: optax state \['count', 'extra'\]"):
        checkpoint.optimizer_state_from_jax(odd, model, opt)
    mu = dict(tree["opt_state"][0])
    mu["mu"] = dict(mu["mu"], latent=np.zeros((2, 2), np.float32))
    with pytest.raises(ValueError, match=r"opt_state\.0\.mu\.latent: shape"):
        checkpoint.optimizer_state_from_jax([mu], model, opt)
    with pytest.raises(ValueError, match=r"opt_state\.0\.mu: dtype \['float32'\]"):
        checkpoint.optimizer_state_from_jax(
            tree["opt_state"], model, tstate.AdamBf16Mu(model.parameters()))
    sgd = torch.optim.SGD(model.parameters(), lr=1e-3, momentum=0.9)
    with pytest.raises(ValueError, match=r"opt_state: states \['opt_state.0'\].*'trace'"):
        checkpoint.optimizer_state_from_jax(tree["opt_state"], model, sgd)


def test_directories_in_neither_or_both_layouts_raise(tmp_path):
    _, cfg = tiny_cfg()
    _, _, model = build(cfg, CPU)
    d = tmp_path / "model"
    (d / "0").mkdir(parents=True)
    (d / "0" / "notes.txt").write_text("x")
    with pytest.raises(ValueError, match="neither state.pt nor an orbax checkpoint"):
        checkpoint.load_weights(str(d), model)
    shutil.rmtree(d / "0")
    shutil.copytree(os.path.join(FIX, "adam_f32", "0"), d / "0")
    (d / "0" / checkpoint.STATE_FILE).write_bytes(b"")
    with pytest.raises(ValueError, match="holds both"):
        checkpoint.load_checkpoint(str(d), tstate.create_train_state(cfg, model))
    os.remove(d / "0" / "manifest.ocdbt")
    os.remove(d / "0" / checkpoint.STATE_FILE)
    with pytest.raises(ValueError, match="neither"):
        checkpoint.load_weights(str(d), model)


GUARD = r"""
import os, sys
BLOCKED = ("jax", "jaxlib", "orbax", "tensorstore", "instant_nvr_tpu", "cv2", "imageio",
           "PIL", "zstandard", "google_crc32c", "xxhash")
for name in BLOCKED:
    sys.modules[name] = None            # any import of them raises ImportError
import torch, yaml
from instant_nvr_tpu_torch.config import make_cfg
from instant_nvr_tpu_torch.run import build
from instant_nvr_tpu_torch.tools import import_jax_ckpt
from instant_nvr_tpu_torch.train import checkpoint, orbax_format
src, yml, out = sys.argv[1], sys.argv[2], sys.argv[3]
tree = orbax_format.read_checkpoint(os.path.join(src, "0"), None)
assert set(tree) == {"params", "opt_state", "step", "meta"}
cfg = make_cfg(yml)
_, _, model = build(cfg, torch.device("cpu"))
checkpoint.load_weights(src, model)
import_jax_ckpt.main(["--cfg_file", yml, "--src", src, "--out", out, "--device", "cpu"])
_, _, other = build(cfg, torch.device("cpu"), seed=3)
checkpoint.load_weights(out, other)
assert all(torch.equal(a, b) for a, b in zip(model.state_dict().values(),
                                             other.state_dict().values()))
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def test_reader_converter_and_load_weights_without_jax_or_orbax(tmp_path):
    yml = tiny_yaml(tmp_path, {})
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", GUARD, os.path.join(FIX, "adam_f32"), yml,
                          str(tmp_path / "out")], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"


if __name__ == "__main__":
    regenerate()
    print(f"wrote {FIX}")
