"""The port's mp4 writer without ffmpeg (``eval/video.py`` on
``instant_nvr_tpu_torch/csrc/mp4v.cpp``), on the CPU.

``merge_into_video`` runs with the ffmpeg lookup stubbed out (an empty
PATH), so the mp4v writer is the path under test; cv2 (built with FFMPEG
video I/O here) is only the oracle: it decodes every file to the frame
count, the fps and the size written, and each decoded frame reaches the
PSNR against its PNG stated in ``PSNR_FLOOR`` (dB, at the default
quantiser 4; the floors are the values measured on these seeded frames,
rounded down to 0.1 dB; rendered 39.09-39.48, noise 13.02-13.05, gray
checkerboard 42.85, coloured checkerboard 5.41, 17x33 35.11-39.15,
513x511 44.77-44.83).  What bounds them: rendered-looking frames and the
gray checkerboard lose only to quantisation; noise and a checkerboard of
complementary colours lose their colour detail to 4:2:0 chroma (cv2's own
mp4v writer gives 13.0 and 5.42 dB on the same frames).  The file has
cv2's ``ftyp`` brands and an ``mp4v`` sample entry with the MPEG-4 Visual
object type, as cv2's own mp4v output; the port's reader parses both;
inputs out of range raise; the encoder runs under AddressSanitizer and
UBSan; the modules run with jax, cv2, imageio and PIL blocked.
"""
import os
import shutil
import subprocess
import sys

import cv2
import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from instant_nvr_tpu_torch.datasets.image_ops import write_png  # noqa: E402
from instant_nvr_tpu_torch.eval import video, visualizer  # noqa: E402

PSNR_FLOOR = {"rendered": 39.0, "noise": 13.0, "checker-gray": 42.8,
              "checker-colour": 5.4, "odd-17x33": 35.1, "odd-513x511": 44.7}


def rendered(H, W, t):
    """A shaded sphere over a dark gradient: smooth shading, one hard edge."""
    y, x = (np.mgrid[0:H, 0:W] + 0.5) / max(H, W)
    cx, cy, r = 0.5 + 0.05 * t, 0.5 * H / max(H, W), 0.3 * min(H, W) / max(H, W)
    d2 = ((x - cx) ** 2 + (y - cy) ** 2) / r ** 2
    z = np.sqrt(np.clip(1 - d2, 0, 1))
    shade = np.clip(0.2 + 0.8 * (0.3 * (x - cx) / r + 0.5 * (cy - y) / r + 0.8 * z), 0, 1)
    body = np.stack([0.9 * shade, 0.6 * shade, 0.4 * shade], -1)
    bg = np.stack([0.1 + 0.1 * x, 0.1 + 0.05 * y, 0.15 + 0.0 * x], -1)
    img = np.where((d2 < 1)[..., None], body, bg)
    return (img * 255 + 0.5).astype(np.uint8)


def frames_of(name):
    rng = np.random.default_rng(len(name))
    if name == "rendered":
        return [rendered(96, 128, t) for t in range(6)]
    if name == "noise":
        return [rng.integers(0, 256, (48, 64, 3), dtype=np.uint8) for _ in range(3)]
    if name.startswith("checker"):
        c = (np.indices((64, 48)).sum(0) % 2 * 255).astype(np.uint8)
        f = np.stack([c, c, c] if name == "checker-gray" else [c, 255 - c, c], -1)
        return [f, 255 - f]
    H, W = (33, 17) if name == "odd-17x33" else (511, 513)
    return [rendered(H, W, t) for t in range(3)]


def psnr(a, b):
    m = np.mean((a.astype(np.float64) - b.astype(np.float64)) ** 2)
    return 10 * np.log10(255.0 ** 2 / max(m, 1e-12))


def decode(path):
    cap = cv2.VideoCapture(path)
    assert cap.isOpened(), path
    out = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        out.append(frame[..., ::-1])
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return out, fps


def merge(tmp_path, frames, monkeypatch, fps=24):
    """Write the frames as PNGs and merge them with ffmpeg out of reach."""
    monkeypatch.setenv("PATH", str(tmp_path / "no-ffmpeg"))
    assert shutil.which("ffmpeg") is None
    d = tmp_path / "frames"
    d.mkdir()
    for i, f in enumerate(frames):
        write_png(str(d / f"frame_{i:04d}.png"), f)
    out = str(tmp_path / "out.mp4")
    assert visualizer.merge_into_video(str(d), out, fps) is True
    return out


@pytest.mark.parametrize("name", sorted(PSNR_FLOOR))
def test_cv2_decodes_each_frame(name, tmp_path, monkeypatch):
    frames = frames_of(name)
    out = merge(tmp_path, frames, monkeypatch)
    got, fps = decode(out)
    H, W = frames[0].shape[:2]
    assert len(got) == len(frames) and fps == 24.0
    assert all(g.shape == (H, W, 3) for g in got)
    values = [psnr(g, f) for g, f in zip(got, frames)]
    assert min(values) >= PSNR_FLOOR[name], (name, values)
    info = video.read_mp4(out)
    assert (info["width"], info["height"]) == (W, H)
    assert len(info["sample_sizes"]) == len(frames) == len(info["sync_samples"])


@pytest.mark.parametrize("fps", [1, 5, 30])
def test_frame_rates_and_time_stamps(fps, tmp_path, monkeypatch):
    """More frames than a second holds: the VOPs' modulo_time_base."""
    frames = [rendered(32, 48, t) for t in range(2 * fps + 1)]
    got, got_fps = decode(merge(tmp_path, frames, monkeypatch, fps))
    assert len(got) == len(frames) and got_fps == float(fps)


def test_brand_and_sample_entry_match_cv2s_own_mp4v(tmp_path, monkeypatch):
    frames = frames_of("rendered")
    mine = video.read_mp4(merge(tmp_path, frames, monkeypatch))
    ref_path = str(tmp_path / "cv2.mp4")
    w = cv2.VideoWriter(ref_path, cv2.VideoWriter_fourcc(*"mp4v"), 24,
                        (frames[0].shape[1], frames[0].shape[0]))
    for f in frames:
        w.write(np.ascontiguousarray(f[..., ::-1]))
    w.release()
    ref = video.read_mp4(ref_path)
    for k in ("brand", "compatible", "codec", "object_type", "width", "height"):
        assert mine[k] == ref[k], k
    assert mine["codec"] == "mp4v" and mine["object_type"] == 0x20
    # both configurations hold a visual object sequence and a VOL
    for h in (mine["headers"], ref["headers"]):
        assert h.startswith(b"\x00\x00\x01\xb0") and b"\x00\x00\x01\x20" in h


@pytest.mark.parametrize("frames,match", [
    ([], "no frames"),
    ([np.zeros((16, 16, 3), np.uint8), np.zeros((16, 32, 3), np.uint8)], "mixed sizes"),
    ([np.zeros((15, 64, 3), np.uint8)], "16..4096"),
    ([np.zeros((16, 4097, 3), np.uint8)], "16..4096"),
    ([np.zeros((16, 16), np.uint8)], r"\(H, W, 3\) uint8"),
    ([np.zeros((16, 16, 3), np.float32)], r"\(H, W, 3\) uint8"),
])
def test_inputs_out_of_range_raise(frames, match, tmp_path):
    with pytest.raises(ValueError, match=match):
        video.write_mp4(str(tmp_path / "x.mp4"), frames)
    assert not os.listdir(tmp_path)                 # no file left behind


@pytest.mark.parametrize("fps,quant", [(0, 4), (24.5, 4), (70000, 4), (24, 0), (24, 32)])
def test_rates_out_of_range_raise(fps, quant, tmp_path):
    with pytest.raises(ValueError, match="fps|quant"):
        video.write_mp4(str(tmp_path / "x.mp4"), [np.zeros((16, 16, 3), np.uint8)], fps, quant)


def test_reader_refuses_damaged_files(tmp_path):
    path = str(tmp_path / "a.mp4")
    video.write_mp4(path, frames_of("checker-gray"))
    data = open(path, "rb").read()
    for i, bad in enumerate((data[:len(data) - 9], data[:40],
                             data[:28] + b"\xff\xff\xff\xff" + data[32:])):
        p = str(tmp_path / f"bad{i}.mp4")
        open(p, "wb").write(bad)
        with pytest.raises(ValueError, match=p):
            video.read_mp4(p)


HARNESS = r"""
#include <cstdio>
#include <cstdint>
#include <random>
#include <vector>
extern "C" long long mp4v_frame_capacity(int, int);
extern "C" long long mp4v_headers(int, int, int, uint8_t*, long long);
extern "C" long long mp4v_encode_frame(const uint8_t*, int, int, int, long long, int,
                                       uint8_t*, long long);
int main() {
  std::mt19937 rng(7);
  const int sizes[][2] = {{16, 16}, {17, 33}, {31, 16}, {48, 40}, {4096, 16}, {16, 4096}};
  long long ok = 0, full = 0, bad = 0;
  for (auto& s : sizes) {
    const int W = s[0], H = s[1];
    std::vector<uint8_t> rgb((size_t)W * H * 3);
    for (auto& v : rgb) v = (uint8_t)rng();
    const long long cap = mp4v_frame_capacity(W, H);
    for (int quant : {1, 4, 31}) {
      std::vector<uint8_t> out((size_t)cap);
      if (mp4v_encode_frame(rgb.data(), W, H, 24, 25, quant, out.data(), cap) > 0) ++ok;
      // shorter buffers, exactly sized on the heap: -2 where the frame
      // does not fit, and never a write past the end
      for (long long c : {0LL, 1LL, 7LL, cap / 3}) {
        std::vector<uint8_t> small((size_t)c + 1);
        const long long r = mp4v_encode_frame(rgb.data(), W, H, 24, 0, quant,
                                              small.data() + 1, c);
        if (r == -2 || (r > 0 && r <= c)) ++full;
      }
    }
    uint8_t hdr[64];
    if (mp4v_headers(W, H, 24, hdr, 64) > 0) ++ok;
    if (mp4v_headers(W, H, 24, hdr, 5) == -2) ++full;
  }
  uint8_t px[16 * 16 * 3] = {0}, out[8];
  bad += mp4v_encode_frame(px, 15, 16, 24, 0, 4, out, 8) == -1;
  bad += mp4v_encode_frame(px, 16, 4097, 24, 0, 4, out, 8) == -1;
  bad += mp4v_encode_frame(px, 16, 16, 0, 0, 4, out, 8) == -1;
  bad += mp4v_encode_frame(px, 16, 16, 24, -1, 4, out, 8) == -1;
  bad += mp4v_encode_frame(px, 16, 16, 24, 0, 32, out, 8) == -1;
  bad += mp4v_headers(16, 16, 70000, out, 8) == -1;
  printf("%lld %lld %lld\n", ok, full, bad);
  return 0;
}
"""


def test_encoder_under_address_and_bounds_sanitizers(tmp_path):
    src = tmp_path / "harness.cpp"
    src.write_text(HARNESS)
    exe = tmp_path / "harness"
    cmd = ["g++", "-std=c++17", "-O1", "-g", "-fsanitize=address,undefined",
           "-fno-sanitize-recover=all", "-o", str(exe), str(src), str(video.SOURCE)]
    build = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    assert build.returncode == 0, build.stderr[-3000:]
    res = subprocess.run([str(exe)], capture_output=True, text=True, timeout=300,
                         env={**os.environ, "ASAN_OPTIONS": "detect_leaks=0"})
    assert res.returncode == 0, res.stderr[-3000:]
    # 6 sizes x 3 quantisers + 6 headers; 6 x 3 x 4 short buffers + 6; 6 refusals
    assert res.stdout.split() == ["24", "78", "6"]


GUARD = r"""
import sys
BLOCKED = ("jax", "jaxlib", "instant_nvr_tpu", "cv2", "imageio", "PIL")
for name in BLOCKED:
    sys.modules[name] = None            # any import of them raises ImportError
import numpy as np, torch
from instant_nvr_tpu_torch.eval import video, visualizer
from instant_nvr_tpu_torch.models import inb
from instant_nvr_tpu_torch.ops import scatter, select
out = sys.argv[1]
video.write_mp4(out, [np.full((16, 32, 3), 9 * i, np.uint8) for i in range(3)])
assert len(video.read_mp4(out)["sample_sizes"]) == 3
idx, valid = select.partition_select(torch.rand(300), 64, 0.5)
g = scatter.sorted_scatter_add(torch.randint(0, 9, (50,), dtype=torch.int32),
                               torch.ones(50, 2, dtype=torch.bfloat16), 9)
assert float(g.float().sum()) == 100.0
bad = sorted(m for m in sys.modules if sys.modules[m] is not None
             and m.split(".")[0] in BLOCKED)
assert not bad, bad
print("ok")
"""


def test_new_modules_run_without_jax_cv2_imageio_or_pil(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", GUARD, str(tmp_path / "g.mp4")], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().splitlines()[-1] == "ok"
