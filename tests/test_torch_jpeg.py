"""The port's host image decoder (``csrc/imgdecode.cpp`` through
``datasets/jpeg.py``) against imageio and OpenCV, on the CPU.

Tolerance: none.  Every JPEG the decoder accepts gives the pixels of
``imageio.v2.imread`` (the JAX package's reader: PIL on libjpeg-turbo) bit
for bit, and those of ``cv2.imread`` where cv2 agrees with imageio (it
does on every file here without EXIF orientation).  Every kind it refuses
raises ``ValueError`` naming the file.  The PNG unfilter gives imageio's
pixels and those of the numpy loop it replaced, on files with every row
filter.  The committed fixtures' digests are regenerated with imageio.

    python tests/test_torch_jpeg.py

rewrites the fixture set (``instant_nvr_tpu_torch/datasets/fixtures/jpeg``)
with cv2 and PIL; the port only reads it.
"""
import hashlib
import io
import json
import os
import shutil
import sys
import tempfile

import cv2
import imageio.v2 as imageio
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st
from PIL import Image

from instant_nvr_tpu_torch.datasets import fake_zju, image_ops, jpeg

FIXTURES = fake_zju.JPEG_FIXTURES
BIG = "subject_1024_q95_420.jpg"          # the host decode time's file
SAMPLING = {"444": 0x111111, "422": 0x211111, "420": 0x221111, "440": 0x121111,
            "411": 0x411111}


def smooth_image(h, w, seed=0):
    """Gradients with mild noise: every DCT band and sampling path is hit."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:h, :w]
    a = np.stack([(xx * 3) % 256, (yy * 5) % 256, ((xx + yy) * 2) % 256], -1)
    return (a + rng.integers(-20, 20, a.shape)).clip(0, 255).astype(np.uint8)


def encode(img, quality=75, sampling="420", optimize=False, restart=0):
    """cv2's JPEG bytes of an RGB (or gray) image."""
    arr = img[..., ::-1] if img.ndim == 3 else img
    params = [cv2.IMWRITE_JPEG_QUALITY, quality,
              cv2.IMWRITE_JPEG_OPTIMIZE, int(optimize),
              cv2.IMWRITE_JPEG_RST_INTERVAL, restart]
    if img.ndim == 3:
        params += [cv2.IMWRITE_JPEG_SAMPLING_FACTOR, SAMPLING[sampling]]
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(arr), params)
    assert ok
    return buf.tobytes()


def segments(data):
    """(marker, segment bytes) up to the first scan, then the rest."""
    out, p = [], 2
    while p < len(data):
        m, n = data[p + 1], int.from_bytes(data[p + 2:p + 4], "big")
        if m == 0xDA:
            out.append((m, data[p:]))
            break
        out.append((m, data[p:p + 2 + n]))
        p += 2 + n
    return out


def with_16bit_tables_and_sof1(data):
    """The same image with its quantisation tables stored as 16-bit values
    and its frame marked SOF1 (extended sequential): the same pixels."""
    out = bytearray(data[:2])
    for m, seg in segments(data):
        if m == 0xDB:
            body, q = bytearray(), 4
            while q < len(seg):
                body.append(0x10 | (seg[q] & 15))
                body += b"".join(int(v).to_bytes(2, "big") for v in seg[q + 1:q + 65])
                q += 65
            out += b"\xff\xdb" + (len(body) + 2).to_bytes(2, "big") + body
        elif m == 0xC0:
            out += b"\xff\xc1" + seg[2:]
        else:
            out += seg
    return bytes(out)


def with_marker(data, old, new):
    i = data.index(bytes([0xFF, old]))
    return data[:i + 1] + bytes([new]) + data[i + 2:]


def with_precision(data, bits):
    i = data.index(b"\xff\xc0")
    return data[:i + 4] + bytes([bits]) + data[i + 5:]


def with_adobe_rgb(data):
    """An Adobe APP14 segment with transform 0 (RGB) in place of JFIF."""
    adobe = b"Adobe" + bytes([0, 100, 0, 0, 0, 0, 0])
    seg = b"\xff\xee" + (len(adobe) + 2).to_bytes(2, "big") + adobe
    rest = b"".join(s for m, s in segments(data) if m != 0xE0)
    return data[:2] + seg + rest


def pil_bytes(img, **kw):
    b = io.BytesIO()
    Image.fromarray(img).save(b, "JPEG", **kw)
    return b.getvalue()


def digest(a):
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def reference(path_or_bytes):
    src = io.BytesIO(path_or_bytes) if isinstance(path_or_bytes, bytes) else path_or_bytes
    return np.asarray(imageio.imread(src))


def assert_decodes_like_imageio(data, check_cv2=True):
    want = reference(data)
    got = jpeg.decode_jpeg(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    if check_cv2:
        flag = cv2.IMREAD_COLOR if want.ndim == 3 else cv2.IMREAD_GRAYSCALE
        c = cv2.imdecode(np.frombuffer(data, np.uint8), flag)
        np.testing.assert_array_equal(c[..., ::-1] if c.ndim == 3 else c, want)


# -- the fixture set -------------------------------------------------------------

def fixture_variants():
    """{file name: JPEG bytes} of the decoded variants, and of the refused
    ones (name -> (bytes, what the message says))."""
    img = smooth_image(33, 49, seed=1)
    ok = {f"q75_{s}.jpg": encode(img, 75, s) for s in ("444", "422", "420", "440")}
    ok.update({
        "q75_gray.jpg": encode(img[..., 1].copy(), 75),
        "q5_420.jpg": encode(img, 5, "420"),
        "q100_444.jpg": encode(img, 100, "444"),
        "q75_420_optimized.jpg": encode(img, 75, "420", optimize=True),
        "q75_420_restart2.jpg": encode(img, 75, "420", restart=2),
        "q30_dqt16_sof1.jpg": with_16bit_tables_and_sof1(encode(img, 30, "422")),
        "pil_q90_420_optimized.jpg": pil_bytes(img, quality=90, subsampling=2,
                                               optimize=True),
        "size_1x1.jpg": encode(smooth_image(1, 1, seed=2), 75, "420"),
        "size_7x5.jpg": encode(smooth_image(7, 5, seed=3), 75, "420"),
    })
    with tempfile.TemporaryDirectory() as tmp:
        # a capture-sized frame: the fake subject's view at 1024^2
        fake_zju.write_fake_dataset(tmp, n_frames=1, n_views=1, H=1024, W=1024,
                                    supersample=1)
        big = image_ops.read_png(os.path.join(tmp, "images", "Cam0", "0000.png"))
    ok[BIG] = encode(big, 95, "420")
    base = encode(img, 75, "420")
    refused = {
        "progressive.jpg": (pil_bytes(img, quality=75, progressive=True), "progressive"),
        "cmyk.jpg": (_cmyk(img), "CMYK"),
        "sampling_411.jpg": (encode(img, 75, "411"), "sampling factors"),
        "truncated.jpg": (base[:len(base) // 2], "truncated"),
    }
    return ok, refused


def _cmyk(img):
    b = io.BytesIO()
    Image.fromarray(img).convert("CMYK").save(b, "JPEG", quality=75)
    return b.getvalue()


def write_fixtures(out_dir=FIXTURES):
    """Rewrite the committed fixture set: the variants, the JPEG copies of
    the fake subject's images (q95, 4:2:0) and ``digests.json``."""
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    ok, refused = fixture_variants()
    digests = {"images": {}, "refused": {}}
    for name, data in ok.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
    for name, (data, what) in refused.items():
        with open(os.path.join(out_dir, name), "wb") as f:
            f.write(data)
        digests["refused"][name] = what
    with tempfile.TemporaryDirectory() as tmp:
        fake_zju.write_fake_dataset(tmp, **fake_zju.JPEG_SUBJECT)
        ann = np.load(os.path.join(tmp, "annots.npy"), allow_pickle=True).item()
        for frame in ann["ims"]:
            for rel in frame["ims"]:
                png = image_ops.read_png(os.path.join(tmp, rel))
                name = os.path.join("subject", rel[len("images/"):-4] + ".jpg")
                os.makedirs(os.path.dirname(os.path.join(out_dir, name)), exist_ok=True)
                with open(os.path.join(out_dir, name), "wb") as f:
                    f.write(encode(png, 95, "420"))
    for name in fixture_images(out_dir, refused):
        a = reference(os.path.join(out_dir, name))
        digests["images"][name] = {"shape": list(a.shape), "sha256": digest(a)}
    with open(os.path.join(out_dir, "digests.json"), "w") as f:
        json.dump(digests, f, indent=1, sort_keys=True)
        f.write("\n")


def fixture_images(root=FIXTURES, refused=None):
    """The decodable fixtures' names, relative to ``root``."""
    if refused is None:
        with open(os.path.join(root, "digests.json")) as f:
            refused = json.load(f)["refused"]
    names = [os.path.relpath(os.path.join(d, f), root)
             for d, _, fs in os.walk(root) for f in fs if f.endswith(".jpg")]
    return sorted(n for n in names if n not in refused)


def test_fixture_digests_are_imageio_s_and_the_decoder_s():
    """The committed digests equal imageio's pixels of the committed files
    (the fixtures cannot drift), and the decoder gives the same; the set
    stays small."""
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        committed = json.load(f)
    names = fixture_images()
    assert sorted(committed["images"]) == names and len(names) >= 17
    for name in names:
        path = os.path.join(FIXTURES, name)
        want = reference(path)
        rec = committed["images"][name]
        assert [list(want.shape), digest(want)] == [rec["shape"], rec["sha256"]], name
        np.testing.assert_array_equal(image_ops.read_image(path), want, err_msg=name)
    for name, what in committed["refused"].items():
        with pytest.raises(ValueError, match=f"{name}: .*{what}"):
            image_ops.read_image(os.path.join(FIXTURES, name))
    assert committed["images"][BIG]["shape"] == [1024, 1024, 3]
    total = sum(os.path.getsize(os.path.join(d, f))
                for d, _, fs in os.walk(FIXTURES) for f in fs)
    assert total < 200_000, total


# -- the decoder against imageio and cv2 ------------------------------------------

@pytest.mark.parametrize("quality", [5, 50, 75, 95, 100])
@pytest.mark.parametrize("sampling", ["444", "422", "420", "440", "gray"])
@pytest.mark.parametrize("size", [(1, 1), (7, 5), (17, 33), (250, 333)])
def test_decoder_matches_imageio(size, sampling, quality):
    """Each case runs the four Huffman-table and restart combinations:
    standard or optimised tables, no restarts or a restart every 3 MCUs."""
    img = smooth_image(*size, seed=size[0] * 7 + quality)
    if sampling == "gray":
        img, sampling = img[..., 0].copy(), "444"
    for optimize in (False, True):
        for restart in (0, 3):
            assert_decodes_like_imageio(encode(img, quality, sampling, optimize, restart))


def test_decoder_matches_imageio_at_1024():
    img = smooth_image(1024, 1024, seed=4)
    assert_decodes_like_imageio(encode(img, 95, "420"))
    assert_decodes_like_imageio(encode(img, 75, "444", optimize=True, restart=5))


@settings(max_examples=40, deadline=None)
@given(h=st.integers(1, 40), w=st.integers(1, 40),
       sampling=st.sampled_from(["444", "422", "420", "440", "gray"]),
       quality=st.integers(1, 100), restart=st.integers(0, 4),
       seed=st.integers(0, 2 ** 16))
def test_decoder_matches_imageio_on_random_images(h, w, sampling, quality, restart, seed):
    img = np.random.default_rng(seed).integers(0, 256, (h, w, 3)).astype(np.uint8)
    if sampling == "gray":
        img, sampling = img[..., 0].copy(), "444"
    assert_decodes_like_imageio(encode(img, quality, sampling, restart=restart))


def test_sixteen_bit_tables_and_extended_sequential_frames():
    data = with_16bit_tables_and_sof1(encode(smooth_image(40, 56), 30, "420"))
    assert b"\xff\xc1" in data
    assert_decodes_like_imageio(data)


def test_pil_written_files_match_imageio():
    img = smooth_image(61, 45, seed=5)
    for sub in (0, 1, 2):
        assert_decodes_like_imageio(pil_bytes(img, quality=88, subsampling=sub,
                                              optimize=True), check_cv2=False)


def test_exif_orientation_is_not_applied_as_imageio(tmp_path):
    """imageio.v2.imread ignores the EXIF orientation tag and cv2.imread
    applies it; the decoder follows imageio."""
    img = smooth_image(20, 30, seed=6)
    exif = Image.Exif()
    exif[0x0112] = 6                                   # rotate 90 degrees
    path = str(tmp_path / "rotated.jpg")
    Image.fromarray(img).save(path, "JPEG", quality=90, exif=exif.tobytes())
    want = reference(path)
    assert want.shape == (20, 30, 3) and cv2.imread(path).shape == (30, 20, 3)
    np.testing.assert_array_equal(image_ops.read_image(path), want)


def test_decoder_builds_beside_the_kernels_and_a_failed_build_raises(tmp_path, monkeypatch):
    from instant_nvr_tpu_torch.utils import native
    jpeg.load()
    so = jpeg.library_path()
    assert so.exists() and so.parent == native.BUILD_DIR and so.name.startswith("libimgdecode_")
    bad = tmp_path / "imgdecode.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(jpeg, "SOURCE", bad)
    monkeypatch.setattr(jpeg, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="building imgdecode.cpp failed"):
        jpeg.load()


# -- refusals -------------------------------------------------------------------

def _refused(tmp_path, name, data, what):
    path = str(tmp_path / name)
    with open(path, "wb") as f:
        f.write(data)
    with pytest.raises(ValueError, match=f"{name}: .*{what}"):
        image_ops.read_image(path)


def test_refuses_progressive(tmp_path):
    _refused(tmp_path, "prog.jpg", pil_bytes(smooth_image(24, 24), progressive=True),
             "progressive")


def test_refuses_cmyk(tmp_path):
    _refused(tmp_path, "ink.jpg", _cmyk(smooth_image(24, 24)), "CMYK")


def test_refuses_411_sampling(tmp_path):
    _refused(tmp_path, "s411.jpg", encode(smooth_image(24, 40), 75, "411"),
             "sampling factors 4x1,1x1,1x1")


@pytest.mark.parametrize("cut", [0.5, -10, -2])
def test_refuses_truncated(tmp_path, cut):
    data = encode(smooth_image(40, 30), 75, "420", restart=2)
    n = int(len(data) * cut) if cut > 0 else len(data) + cut
    _refused(tmp_path, "cut.jpg", data[:n], "truncated")


@pytest.mark.parametrize("kind,make,what", [
    ("arithmetic", lambda d: with_marker(d, 0xC0, 0xC9), "arithmetic"),
    ("lossless", lambda d: with_marker(d, 0xC0, 0xC3), "lossless"),
    ("hierarchical", lambda d: with_marker(d, 0xC0, 0xC5), "hierarchical"),
    ("12-bit", lambda d: with_precision(d, 12), "12-bit"),
    ("adobe-rgb", with_adobe_rgb, "Adobe-transformed"),
    ("not-jpeg", lambda d: b"\xff\xd8\xff" + b"\x00" * 40, "marker"),
])
def test_refuses_other_kinds(tmp_path, kind, make, what):
    _refused(tmp_path, f"{kind}.jpg", make(encode(smooth_image(16, 16), 75, "420")), what)


# -- damaged data -----------------------------------------------------------------

def damaged_copies(seed=0):
    """Damaged copies of the committed small baseline fixtures, as
    (label, bytes): every count byte of every Huffman table set to 0, 2 and
    255, and 1, 3 or all of its codes moved to each shorter length (the
    table's size kept, so that it overfills the code tree and only the tree
    check refuses it); every byte of the frame header, the scan header, the
    restart interval and the first bytes of each quantisation table set to
    0, 255 and a seeded value; seeded bit flips and 0xFF bytes in the
    entropy data; and seeded cuts."""
    rng = np.random.default_rng(seed)
    with open(os.path.join(FIXTURES, "digests.json")) as f:
        names = sorted(n for n in json.load(f)["images"] if "/" not in n and n != BIG)
    out = []
    for name in names:
        with open(os.path.join(FIXTURES, name), "rb") as f:
            data = f.read()

        def put(at, values, what):
            b = bytearray(data)
            b[at:at + len(values)] = values
            out.append((f"{name}~{what}@{at}={'.'.join(map(str, values))}", bytes(b)))
        p, scan = 2, len(data)
        for m, seg in segments(data):
            if m == 0xC4:                      # each table: class/id, 16 counts, values
                q = p + 4
                while q < p + len(seg):
                    counts = list(data[q + 1:q + 17])
                    for i in range(16):
                        for v in (0, 2, 255):
                            put(q + 1 + i, [v], "dht-count")
                        for k in (1, 3, sum(counts)):
                            c, moved = counts[:], 0
                            for j in range(15, i, -1):
                                take = min(c[j], k - moved)
                                c[j], moved = c[j] - take, moved + take
                            c[i] += moved
                            if moved and c[i] < 256:
                                put(q + 1, c, "dht-counts")
                    q += 17 + sum(counts)
            elif m in (0xC0, 0xC1, 0xDD, 0xDA, 0xDB):
                n = int.from_bytes(seg[2:4], "big") + 2
                if m == 0xDA:
                    scan = p + n
                for at in range(p + 2, p + (5 if m == 0xDB else n)):
                    for v in (0, 255, int(rng.integers(1, 255))):
                        put(at, [v], f"{m:02X}")
            p += len(seg)
        for at in rng.integers(scan, len(data) - 2, 24):
            put(int(at), [data[at] ^ (1 << int(rng.integers(8)))], "flip")
        for at in rng.integers(scan, len(data) - 2, 8):
            put(int(at), [0xFF], "ff")
        for n in rng.integers(2, len(data) - 1, 8):
            out.append((f"{name}~cut@{n}", data[:n]))
    return out


def _write_blob(tmp_path, copies):
    """The copies as one file of bytes and an index of (label, offset,
    length) lines."""
    blob, index, off = bytearray(), [], 0
    for label, data in copies:
        blob += data
        index.append(f"{label} {off} {len(data)}")
        off += len(data)
    (tmp_path / "blob.bin").write_bytes(bytes(blob))
    (tmp_path / "index.txt").write_text("\n".join(index) + "\n")
    return tmp_path / "blob.bin", tmp_path / "index.txt"


DECODE_ALL = r"""
import sys
from instant_nvr_tpu_torch.datasets import jpeg
blob = open(sys.argv[1], "rb").read()
ok = refused = 0
for line in open(sys.argv[2]):
    label, off, n = line.split()
    try:
        img = jpeg.decode_jpeg(blob[int(off):int(off) + int(n)], label)
    except ValueError as e:
        if not str(e).startswith(label + ": "):
            sys.exit(f"{label}: the error does not name it: {e}")
        refused += 1
    else:
        assert img.dtype.name == "uint8" and img.ndim in (2, 3), label
        ok += 1
print(ok, refused)
"""


def test_damaged_files_decode_or_raise_naming_the_file(tmp_path):
    """Each damaged copy decodes or raises ValueError naming it, in a
    subprocess, so that a crash in the library fails the test instead of
    the test run."""
    import subprocess
    copies = damaged_copies()
    blob, index = _write_blob(tmp_path, copies)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    res = subprocess.run([sys.executable, "-c", DECODE_ALL, str(blob), str(index)],
                         capture_output=True, text=True, cwd=root, timeout=300)
    assert res.returncode == 0, (res.returncode, res.stdout[-2000:], res.stderr[-4000:])
    ok, refused = map(int, res.stdout.split())
    assert ok + refused == len(copies) and refused > len(copies) // 2


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
  while (std::getline(index, line)) {
    std::istringstream in(line);
    std::string label;
    size_t off, n;
    in >> label >> off >> n;
    // a copy of exactly its bytes, so that a read past its end is caught
    std::vector<uint8_t> data(blob.begin() + off, blob.begin() + off + n);
    int64_t dims[3];
    char err[512];
    if (jpeg_header(data.data(), int64_t(n), dims, err, sizeof err) != 0) {
      refused++;
      continue;
    }
    std::vector<uint8_t> out(size_t(dims[0] * dims[1] * dims[2]));
    if (jpeg_decode(data.data(), int64_t(n), out.data(), err, sizeof err) != 0) refused++;
    else ok++;
  }
  printf("%d %d\n", ok, refused);
  return 0;
}
"""


def test_damaged_files_under_address_and_bounds_sanitizers(tmp_path):
    """The decoder's source, built with AddressSanitizer and UBSan's array
    bounds checks, over the same damaged copies: no read or write out of
    bounds (the process aborts on the first)."""
    import subprocess
    (tmp_path / "harness.cpp").write_text(HARNESS.replace("SOURCE", str(jpeg.SOURCE)))
    exe = tmp_path / "harness"
    cmd = ["g++", "-O1", "-g", "-std=c++17", "-fsanitize=address,undefined",
           "-fno-sanitize-recover=all", "-o", str(exe), str(tmp_path / "harness.cpp")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    assert res.returncode == 0, res.stderr[-4000:]
    copies = damaged_copies()
    blob, index = _write_blob(tmp_path, copies)
    res = subprocess.run([str(exe), str(blob), str(index)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0, (res.returncode, res.stderr[-4000:])
    ok, refused = map(int, res.stdout.split())
    assert ok + refused == len(copies)


def test_read_image_dispatches_on_the_bytes(tmp_path):
    """A JPEG named .png is decoded as JPEG by read_image; read_png still
    refuses it."""
    img = smooth_image(12, 20, seed=7)
    path = str(tmp_path / "frame.png")
    with open(path, "wb") as f:
        f.write(encode(img, 90, "420"))
    np.testing.assert_array_equal(image_ops.read_image(path), reference(path))
    with pytest.raises(ValueError, match="frame.png: a JPEG image"):
        image_ops.read_png(path)


# -- PNG row filters --------------------------------------------------------------

def unfilter_numpy(raw, filters, bpp):
    """The numpy anti-diagonal loop the C++ pass replaced (the plain
    version it is held to)."""
    H, W, _ = raw.shape
    X = np.zeros((H + 1, W + 1, bpp), np.int32)
    raw = raw.astype(np.int32)
    for d in range(H + W - 1):
        r = np.arange(max(0, d - W + 1), min(H, d + 1))
        x = d - r
        a, b, c = X[r + 1, x], X[r, x + 1], X[r, x]
        p = a + b - c
        pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
        paeth = np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))
        f = filters[r][:, None]
        pred = np.select([f == 1, f == 2, f == 3, f == 4],
                         [a, b, (a + b) >> 1, paeth], 0)
        X[r + 1, x + 1] = (raw[r, x] + pred) & 0xFF
    return X[1:, 1:].astype(np.uint8)


def png_rows(path):
    """The decompressed filtered rows of a PNG and its bytes per pixel."""
    import struct
    import zlib
    data = open(path, "rb").read()
    pos, idat = 8, []
    while pos < len(data):
        n, kind = struct.unpack(">I", data[pos:pos + 4])[0], data[pos + 4:pos + 8]
        if kind == b"IHDR":
            W, H, _, ctype = struct.unpack(">IIBB", data[pos + 8:pos + 18])
        elif kind == b"IDAT":
            idat.append(data[pos + 8:pos + 8 + n])
        pos += 12 + n
    bpp = {0: 1, 2: 3, 6: 4}[ctype]
    return np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8).reshape(H, -1), bpp


def write_filtered_png(path, writer, channels, size):
    """A PNG written by cv2 (libpng's adaptive filter choice) or PIL
    (``optimize=True``), smooth below noisy rows; -> the image."""
    img = smooth_image(*size, seed=channels)
    img[: size[0] // 3] = np.random.default_rng(0).integers(0, 256, img[: size[0] // 3].shape)
    if channels == 1:
        img = img[..., 0].copy()
    elif channels == 4:
        img = np.concatenate([img, img[..., :1] // 2 + 60], -1)
    if writer == "cv2":
        bgr = img if channels == 1 else img[..., [2, 1, 0] + ([3] if channels == 4 else [])]
        cv2.imwrite(path, np.ascontiguousarray(bgr))
    else:
        Image.fromarray(img).save(path, optimize=True)
    return img


PNG_CASES = [(w, c, s) for w in ("cv2", "pil") for c in (1, 3, 4)
             for s in ((37, 53), (101, 77))]


@pytest.mark.parametrize("writer,channels,size", PNG_CASES)
def test_png_unfilter_every_filter(tmp_path, writer, channels, size):
    """read_png of cv2's and PIL's files (odd sizes, gray, RGB and RGBA)
    against imageio, and the C++ unfilter against the numpy loop."""
    path = str(tmp_path / "f.png")
    img = write_filtered_png(path, writer, channels, size)
    rows, bpp = png_rows(path)
    got = image_ops.read_png(path)
    np.testing.assert_array_equal(got, imageio.imread(path))
    np.testing.assert_array_equal(got, img)
    raw = rows[:, 1:].reshape(rows.shape[0], -1, bpp)
    np.testing.assert_array_equal(jpeg.png_unfilter(rows, bpp).reshape(raw.shape),
                                  unfilter_numpy(raw, rows[:, 0], bpp))


def test_png_cases_use_every_filter(tmp_path):
    seen = set()
    for writer, channels, size in PNG_CASES:
        path = str(tmp_path / f"{writer}{channels}{size[0]}.png")
        write_filtered_png(path, writer, channels, size)
        seen |= set(png_rows(path)[0][:, 0].tolist())
    assert seen == {0, 1, 2, 3, 4}, seen


def test_png_unfilter_covers_all_five_filters_and_refuses_others():
    rng = np.random.default_rng(1)
    rows = rng.integers(0, 256, (10, 1 + 9 * 3)).astype(np.uint8)
    rows[:, 0] = [0, 1, 2, 3, 4, 4, 3, 2, 1, 0]
    raw = rows[:, 1:].reshape(10, 9, 3)
    np.testing.assert_array_equal(jpeg.png_unfilter(rows, 3).reshape(raw.shape),
                                  unfilter_numpy(raw, rows[:, 0], 3))
    rows[4, 0] = 7
    with pytest.raises(ValueError, match="filter 7"):
        jpeg.png_unfilter(rows, 3)


if __name__ == "__main__":
    write_fixtures(sys.argv[1] if len(sys.argv) > 1 else FIXTURES)
    print("wrote", sys.argv[1] if len(sys.argv) > 1 else FIXTURES)
