"""The image operations of the data layer, on numpy and scipy only.

The JAX package's data layer calls OpenCV and imageio; the port runs
where neither (nor PIL) is installed.  Each function here reproduces the
call it replaces in OpenCV's pixel conventions, so the port's dataset
items match the JAX package's (``tests/test_torch_data.py`` holds them
against cv2 and imageio):

  - :func:`read_image` / :func:`read_png`: an 8-bit gray, RGB or RGBA PNG
    of unfiltered rows, on ``zlib`` + ``struct``; :func:`write_png`;
  - :func:`rodrigues` (``cv2.Rodrigues``, vector -> matrix);
  - :func:`resize_nearest` / :func:`resize_area` (``cv2.resize`` with
    ``INTER_NEAREST`` / ``INTER_AREA``);
  - :func:`undistort` (``cv2.undistort``, the 5-coefficient model);
  - :func:`erode` / :func:`dilate` with a square kernel.
"""
from __future__ import annotations

import struct
import zlib

import numpy as np
from scipy import ndimage


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}           # PNG colour type -> channels


# --------------------------------------------------------------------------
# PNG
# --------------------------------------------------------------------------

def _unfilter(raw: np.ndarray, filters: np.ndarray, bpp: int) -> np.ndarray:
    """The image bytes of unfiltered rows (the subject writer's files); a
    filtered row raises."""
    if filters.any():
        raise ValueError("the reference reads unfiltered PNG rows only")
    return raw


def read_image(path: str) -> np.ndarray:
    """An 8-bit PNG (:func:`read_png`)."""
    return read_png(path)


def read_png(path: str) -> np.ndarray:
    """An 8-bit gray (H, W), RGB (H, W, 3) or RGBA (H, W, 4) PNG as uint8,
    as ``imageio.imread`` returns it.  Raises ``ValueError`` naming the
    file for anything else (JPEG, palette, 16-bit or interlaced PNG)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_MAGIC:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        (n,), kind = struct.unpack(">I", data[pos:pos + 4]), data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    W, H, depth, ctype, _, _, interlace = hdr
    if depth != 8 or ctype not in _CHANNELS or interlace:
        raise ValueError(f"{path}: PNG bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace}; only 8-bit gray/RGB/RGBA, "
                         "not interlaced, is read")
    bpp = _CHANNELS[ctype]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(H, 1 + W * bpp)
    filters = rows[:, 0]
    if (filters > 4).any():
        raise ValueError(f"{path}: PNG row filter {int(filters.max())} unknown")
    img = _unfilter(rows[:, 1:].reshape(H, W, bpp), filters, bpp)
    return img[..., 0] if bpp == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """Write a uint8 gray (H, W), RGB (H, W, 3) or RGBA (H, W, 4) image as
    a PNG (no row filter)."""
    img = np.ascontiguousarray(img)
    if img.dtype != np.uint8:
        raise ValueError(f"write_png: uint8 image expected, got {img.dtype}")
    ch = 1 if img.ndim == 2 else img.shape[2]
    ctype = {1: 0, 3: 2, 4: 6}.get(ch)
    if ctype is None:
        raise ValueError(f"write_png: {ch} channels; 1, 3 or 4 are written")
    H, W = img.shape[:2]
    rows = np.concatenate([np.zeros((H, 1), np.uint8), img.reshape(H, W * ch)], 1)
    with open(path, "wb") as f:
        f.write(_PNG_MAGIC
                + _chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype, 0, 0, 0))
                + _chunk(b"IDAT", zlib.compress(rows.tobytes()))
                + _chunk(b"IEND", b""))


# --------------------------------------------------------------------------
# geometry
# --------------------------------------------------------------------------

def rodrigues(r) -> np.ndarray:
    """Rotation vector (3,) -> float64 (3, 3) matrix, in ``cv2.Rodrigues``'
    order of operations: c I + (1 - c) k k^T + s [k]x."""
    r = np.asarray(r, np.float64).reshape(3)
    theta = float(np.sqrt(r[0] * r[0] + r[1] * r[1] + r[2] * r[2]))
    if theta < np.finfo(np.float64).eps:
        return np.eye(3)
    c, s = np.cos(theta), np.sin(theta)
    x, y, z = r * (1.0 / theta)
    rrt = np.array([[x * x, x * y, x * z], [x * y, y * y, y * z],
                    [x * z, y * z, z * z]])
    r_x = np.array([[0.0, -z, y], [z, 0.0, -x], [-y, x, 0.0]])
    return c * np.eye(3) + (1.0 - c) * rrt + s * r_x


# --------------------------------------------------------------------------
# resize
# --------------------------------------------------------------------------

def resize_nearest(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=INTER_NEAREST)``: output pixel
    x reads source pixel floor(x * src / dst), OpenCV's double arithmetic."""
    h0, w0 = img.shape[:2]
    if (h0, w0) == (H, W):
        return img.copy()
    sx = np.minimum(np.floor(np.arange(W) * (1.0 / (W / w0))).astype(np.int64), w0 - 1)
    sy = np.minimum(np.floor(np.arange(H) * (1.0 / (H / h0))).astype(np.int64), h0 - 1)
    return img[sy[:, None], sx[None, :]]


def _area_table(src: int, dst: int):
    """OpenCV's area decimation along one axis (``computeResizeAreaTab``):
    for each output cell the source cells it covers, in order, and their
    float32 weights (a partly covered cell by its covered share), padded
    with weight 0 -> (index (dst, k), weight (dst, k))."""
    scale = 1.0 / (dst / src)
    cells = []
    for dx in range(dst):
        fsx1 = dx * scale
        fsx2 = fsx1 + scale
        cell = min(scale, src - fsx1)
        sx1, sx2 = int(np.ceil(fsx1)), int(np.floor(fsx2))
        sx2 = min(sx2, src - 1)
        sx1 = min(sx1, sx2)
        tab = []
        if sx1 - fsx1 > 1e-3:
            tab.append((sx1 - 1, (sx1 - fsx1) / cell))
        tab += [(sx, 1.0 / cell) for sx in range(sx1, sx2)]
        if fsx2 - sx2 > 1e-3:
            tab.append((sx2, min(min(fsx2 - sx2, 1.0), cell) / cell))
        cells.append(tab)
    k = max(len(t) for t in cells)
    idx = np.zeros((dst, k), np.int64)
    wgt = np.zeros((dst, k), np.float32)
    for dx, tab in enumerate(cells):
        for j, (sx, a) in enumerate(tab):
            idx[dx, j], wgt[dx, j] = sx, np.float32(a)
    return idx, wgt


def resize_area(img: np.ndarray, W: int, H: int) -> np.ndarray:
    """``cv2.resize(img, (W, H), interpolation=INTER_AREA)`` for a float32
    image, downscaling, bit-equal.  At integer factors an output pixel is
    the sum of its k x k block in OpenCV's order (row by row, left to right)
    times 1 / k^2; at other factors each row is first summed across with
    the area weights, then the rows down, both in float32 and in OpenCV's
    order."""
    h0, w0 = img.shape[:2]
    if (h0, w0) == (H, W):
        return img.copy()
    if H > h0 or W > w0 or img.dtype != np.float32:
        raise ValueError(f"resize_area: float32 downscale only, not "
                         f"{img.dtype} ({h0}, {w0}) -> ({H}, {W})")
    kx, ky = w0 / W, h0 / H
    if kx == int(kx) and ky == int(ky):
        kx, ky = int(kx), int(ky)
        blocks = img[:H * ky, :W * kx].reshape(H, ky, W, kx, *img.shape[2:])
        acc = np.zeros((H, W) + img.shape[2:], img.dtype)
        for i in range(ky):
            for j in range(kx):
                acc = acc + blocks[:, i, :, j]
        return acc * np.float32(1.0 / (kx * ky))
    ix, wx = _area_table(w0, W)
    iy, wy = _area_table(h0, H)
    ch = (None,) * (img.ndim - 2)
    rows = np.zeros((h0, W) + img.shape[2:], np.float32)
    for k in range(ix.shape[1]):
        rows = rows + img[:, ix[:, k]] * wx[(None, slice(None), k) + ch]
    out = rows[iy[:, 0]] * wy[(slice(None), 0, None) + ch]
    for k in range(1, iy.shape[1]):
        out = out + rows[iy[:, k]] * wy[(slice(None), k, None) + ch]
    return out


# --------------------------------------------------------------------------
# undistort
# --------------------------------------------------------------------------

def undistort(img: np.ndarray, K: np.ndarray, D: np.ndarray) -> np.ndarray:
    """``cv2.undistort(img, K, D)`` (new camera matrix = K).  All-zero ``D``
    returns the image unchanged, as OpenCV's identity map does.  Otherwise
    every output pixel is the distorted point of OpenCV's 5-coefficient
    model (k1, k2, p1, p2, k3), rounded to 1/32 pixel, sampled bilinearly
    with a zero border; uint8 images with OpenCV's 15-bit fixed-point
    weights."""
    D = np.asarray(D, np.float64).ravel()
    if not D.any():
        return img.copy()
    k1, k2, p1, p2 = D[:4]
    k3 = D[4] if len(D) > 4 else 0.0
    K = np.asarray(K, np.float64)
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    H, W = img.shape[:2]
    v, u = np.meshgrid(np.arange(H, dtype=np.float64),
                       np.arange(W, dtype=np.float64), indexing="ij")
    x, y = (u - cx) / fx, (v - cy) / fy
    x2, y2 = x * x, y * y
    r2, xy2 = x2 + y2, 2 * x * y
    kr = 1 + ((k3 * r2 + k2) * r2 + k1) * r2
    us = fx * (x * kr + p1 * xy2 + p2 * (r2 + 2 * x2)) + cx
    vs = fy * (y * kr + p1 * (r2 + 2 * y2) + p2 * xy2) + cy
    iu, iv = np.rint(us * 32).astype(np.int64), np.rint(vs * 32).astype(np.int64)
    x0, y0 = iu >> 5, iv >> 5
    ax = (iu & 31).astype(np.float32) / np.float32(32)
    ay = (iv & 31).astype(np.float32) / np.float32(32)
    w = [(1 - ay) * (1 - ax), (1 - ay) * ax, ay * (1 - ax), ay * ax]   # float32

    def corner(dy, dx):
        yy, xx = y0 + dy, x0 + dx
        inside = (yy >= 0) & (yy < H) & (xx >= 0) & (xx < W)
        vals = img[np.clip(yy, 0, H - 1), np.clip(xx, 0, W - 1)]
        return np.where(inside.reshape(inside.shape + (1,) * (img.ndim - 2)), vals, 0)

    c = [corner(0, 0), corner(0, 1), corner(1, 0), corner(1, 1)]
    extra = (slice(None),) * 2 + (None,) * (img.ndim - 2)
    if img.dtype == np.uint8:
        wi = [np.rint(wk * 32768).astype(np.int64)[extra] for wk in w]
        acc = sum(wk * ck.astype(np.int64) for wk, ck in zip(wi, c))
        return np.clip((acc + (1 << 14)) >> 15, 0, 255).astype(np.uint8)
    out = c[0] * w[0][extra]
    for k in range(1, 4):
        out = out + c[k] * w[k][extra]
    return out.astype(img.dtype)


# --------------------------------------------------------------------------
# polygon fill
# --------------------------------------------------------------------------

_XY_SHIFT, _XY_ONE = 16, 1 << 16


# --------------------------------------------------------------------------
# morphology
# --------------------------------------------------------------------------

def erode(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.erode(img, np.ones((size, size)))``: the minimum over the
    size x size window anchored at (size // 2, size // 2).  OpenCV's border
    value for erosion never wins the minimum, which is what replicating the
    edge (``mode="nearest"``) gives."""
    return ndimage.grey_erosion(img, size=(size, size), mode="nearest")


def dilate(img: np.ndarray, size: int) -> np.ndarray:
    """``cv2.dilate(img, np.ones((size, size)))``: the maximum over the same
    window as :func:`erode`.  ``grey_dilation`` mirrors its window, which
    for an even size moves it by one pixel, so the unmirrored
    ``maximum_filter`` is used."""
    return ndimage.maximum_filter(img, size=(size, size), mode="nearest")
