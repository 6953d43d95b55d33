"""Regenerate the synthetic fixture datasets under data/ with the port's
writer (port of ``tools/make_fixtures.py``, the same three recipes on
``datasets/fake_zju.write_fake_dataset``, whose files equal the JAX
package's writer's).

    python -m instant_nvr_tpu_torch.tools.make_fixtures [--only NAME]

- data/fake_zju   -- 3 views (2 train + 1 held-out), 4 frames, 512^2; used
                     by inb_fake / inb_fake_full (configs/inb).
- data/fake_zju5  -- 5 views (4 train + 1 held-out), 6 frames (frames 4-5
                     reserved for the novel-pose protocol), 512^2; used by
                     inb_fake_mv / inb_fake_mv_np.
- data/fake_zju_big (only with ``--only fake_zju_big``) -- 5 views x 100
                     frames at 1024^2 with SMPL's 6,890 vertices, trained
                     at ratio 0.5 as inb_377 is.

All are rendered with 4x4 (2x2 for the big one) supersampled ground truth
and the procedural texture.  Host numpy only: it runs no device code.

:func:`write_orbax_checkpoint` writes a numpy tree in the file set of the
JAX package's orbax checkpoints (``train/orbax_format.py`` describes it),
with zstd frames of raw and RLE blocks, which are valid zstd.  The card's
machine has no orbax, so this is how a full-width checkpoint of the JAX
layout is made there (``chip_smoke.py`` phase 12); orbax's restore and the
JAX package's ``load_checkpoint`` read what it writes
(``tests/test_torch_orbax.py``).  Nothing on the port's path writes this
format.
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import struct
import time
import uuid
from typing import List, Tuple

import numpy as np
import torch

from ..datasets.fake_zju import write_fake_dataset
from ..train import orbax_format

BLOCK = 128 * 1024                 # zstd's largest block
MAX_INLINE = 1024                  # tensorstore's default max_inline_value_bytes
MAX_NODE = 100_000_000             # and max_decoded_node_bytes
HANDLER = ("orbax.checkpoint._src.handlers.standard_checkpoint_handler."
           "StandardCheckpointHandler")


def _varint(v: int) -> bytes:
    out = bytearray()
    while True:
        out.append((v & 0x7F) | (0x80 if v > 0x7F else 0))
        v >>= 7
        if not v:
            return bytes(out)


def _varints(vs) -> bytes:
    return b"".join(_varint(v) for v in vs)


def zstd_frame(data) -> List[bytes]:
    """One zstd frame of ``data`` in pieces: a single-segment header that
    states the content size, then raw blocks and, where a block is one
    repeated byte, RLE blocks."""
    a = np.frombuffer(data, np.uint8) if not isinstance(data, np.ndarray) else data
    n = a.nbytes
    out = [struct.pack("<IB", orbax_format.ZSTD_MAGIC, 0xE0) + struct.pack("<Q", n)]
    for start in range(0, max(n, 1), BLOCK):
        blk = a[start:start + BLOCK]
        last = int(start + BLOCK >= n)
        if len(blk) > 1 and (blk == blk[0]).all():
            out.append((last | 2 | len(blk) << 3).to_bytes(3, "little") + blk[:1].tobytes())
        else:
            out.append((last | len(blk) << 3).to_bytes(3, "little") + blk.tobytes())
    return out


def _wrap(magic: int, body: bytes) -> bytes:
    """A manifest or B-tree node: header, zstd-framed body, CRC32C."""
    framed = b"".join(zstd_frame(body))
    head = struct.pack(">I", magic)
    total = len(head) + 8 + 2 + len(framed) + 4
    raw = head + struct.pack("<Q", total) + _varint(0) + _varint(1) + framed
    return raw + struct.pack("<I", orbax_format.crc32c(raw))


def _file_table(paths: List[Tuple[str, str]]) -> bytes:
    full = [(b + r).encode() for b, r in paths]
    prefix = [len(os.path.commonprefix([full[i - 1], full[i]])) for i in range(1, len(full))]
    suffix = [f[p:] for f, p in zip(full, [0] + prefix)]
    return (_varint(len(full)) + _varints(prefix) + _varints(len(s) for s in suffix)
            + _varints(len(b.encode()) for b, _ in paths) + b"".join(suffix))


def _leaf_node(entries, files: List[Tuple[str, str]]) -> bytes:
    """A leaf B-tree node of sorted (key, inline bytes or (file id, offset,
    length)) entries."""
    keys = [k for k, _ in entries]
    prefix = [len(os.path.commonprefix([keys[i - 1], keys[i]])) for i in range(1, len(keys))]
    suffix = [k[p:] for k, p in zip(keys, [0] + prefix)]
    refs = [v for _, v in entries if isinstance(v, tuple)]
    return (b"\0" + _file_table(files) + _varint(len(keys)) + _varints(prefix)
            + _varints(len(s) for s in suffix) + b"".join(suffix)
            + _varints(v[2] if isinstance(v, tuple) else len(v) for _, v in entries)
            + bytes(int(isinstance(v, tuple)) for _, v in entries)
            + _varints(r[0] for r in refs) + _varints(r[1] for r in refs)
            + b"".join(v for _, v in entries if not isinstance(v, tuple)))


def _manifest(files, root: Tuple[int, int, int], n_keys: int, indirect: int) -> bytes:
    config = (uuid.uuid4().bytes + _varint(0) + _varint(MAX_INLINE) + _varint(MAX_NODE)
              + bytes([4]) + _varint(1) + struct.pack("<i", 0))
    version = (_varint(1) + _varint(1) + bytes([0]) + _varints(root)
               + _varints((n_keys, root[2], indirect)) + struct.pack("<Q", time.time_ns()))
    return config + _file_table(files) + version + _varint(0)


def write_orbax_checkpoint(path: str, tree) -> None:
    """Write ``tree`` (nested dicts and lists of numpy arrays, torch
    bfloat16 tensors and None) as the orbax checkpoint directory ``path``.
    Leaves under ``meta`` are saved as orbax scalars, ``step`` as a numpy
    array, the rest as jax.Arrays, as the JAX package's ``save_checkpoint``
    saves them."""
    os.makedirs(os.path.join(path, "d"))
    os.makedirs(os.path.join(path, "ocdbt.process_0", "d"))
    os.makedirs(os.path.join(path, "array_metadatas"))
    data_rel = f"d/{uuid.uuid4().hex}"
    entries, tree_meta, sharding, array_meta, indirect = [], {}, {}, [], 0
    with open(os.path.join(path, "ocdbt.process_0", data_rel), "wb") as f:
        for keys, types, leaf in orbax_format.leaves(tree):
            name = ".".join(keys)
            km = [{"key": k, "key_type": t} for k, t in zip(keys, types)]
            if leaf is None:
                tree_meta[str(keys)] = {"key_metadata": km, "value_metadata": {
                    "value_type": "None", "skip_deserialize": True}}
                continue
            if isinstance(leaf, torch.Tensor):
                dtype, arr = "bfloat16", leaf.contiguous().view(torch.uint16).numpy()
            else:
                arr = np.asarray(leaf, order="C")
                dtype = {np.dtype(v): k for k, v in orbax_format.DTYPES.items()
                         if k != "bfloat16"}[arr.dtype]
            shape = list(arr.shape)
            vtype = ("scalar" if keys[0] == "meta" else
                     "np.ndarray" if keys[0] == "step" else "jax.Array")
            vmeta = {"value_type": vtype, "skip_deserialize": False}
            if vtype == "jax.Array":
                vmeta["write_shape"] = shape
                sharding[base64.b64encode(name.encode()).decode()] = json.dumps(
                    {"sharding_type": "SingleDeviceSharding", "device_str": "TFRT_CPU_0"})
                array_meta.append({"array_metadata": {
                    "param_name": name, "write_shape": shape, "chunk_shape": shape,
                    "ext_metadata": None}})
            tree_meta[str(keys)] = {"key_metadata": km, "value_metadata": vmeta}
            zarray = {"chunks": shape, "compressor": {"id": "zstd", "level": 1},
                      "dimension_separator": ".", "dtype": dtype, "fill_value": None,
                      "filters": None, "order": "C", "shape": shape, "zarr_format": 2}
            entries.append((f"{name}/.zarray".encode(),
                            json.dumps(zarray, sort_keys=True, separators=(",", ":")).encode()))
            pieces = zstd_frame(arr.reshape(-1).view(np.uint8))
            size = sum(len(p) for p in pieces)
            key = f"{name}/{'.'.join('0' * len(shape)) or '0'}".encode()
            if size <= MAX_INLINE:
                entries.append((key, b"".join(pieces)))
            else:
                entries.append((key, (0, f.tell(), size)))
                f.writelines(pieces)
                indirect += size
    entries.sort(key=lambda e: e[0])
    # the root database and process 0's both point at the same data file
    for db, files in (("", [("ocdbt.process_0/", data_rel)]), ("ocdbt.process_0", [("", data_rel)])):
        node = _wrap(orbax_format.NODE_MAGIC, _leaf_node(entries, files))
        node_rel = f"d/{uuid.uuid4().hex}"
        with open(os.path.join(path, db, node_rel), "wb") as f:
            f.write(node)
        with open(os.path.join(path, db, "manifest.ocdbt"), "wb") as f:
            f.write(_wrap(orbax_format.MANIFEST_MAGIC, _manifest(
                [("", node_rel)], (0, 0, len(node)), len(entries), indirect)))
    now = time.time_ns()
    docs = {
        "_METADATA": {"tree_metadata": tree_meta, "use_ocdbt": True, "use_zarr3": False,
                      "store_array_data_equal_to_fill_value": True, "custom_metadata": None},
        "_sharding": sharding,
        os.path.join("array_metadatas", "process_0"): {"array_metadatas": array_meta},
        "_CHECKPOINT_METADATA": {"item_handlers": HANDLER, "metrics": {},
                                 "performance_metrics": {}, "init_timestamp_nsecs": now,
                                 "commit_timestamp_nsecs": now, "custom_metadata": {}},
    }
    for rel, doc in docs.items():
        with open(os.path.join(path, rel), "w") as f:
            json.dump(doc, f)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="python -m instant_nvr_tpu_torch.tools.make_fixtures")
    ap.add_argument("--only", choices=["fake_zju", "fake_zju5", "fake_zju_big"],
                    default=None)
    args = ap.parse_args(argv)
    if args.only in (None, "fake_zju"):
        print("writing data/fake_zju (3 views x 4 frames, 512^2) ...")
        write_fake_dataset("data/fake_zju", n_frames=4, n_views=3,
                           H=512, W=512, supersample=4, texture=True)
    if args.only in (None, "fake_zju5"):
        print("writing data/fake_zju5 (5 views x 6 frames, 512^2) ...")
        write_fake_dataset("data/fake_zju5", n_frames=6, n_views=5,
                           H=512, W=512, supersample=4, texture=True)
    if args.only == "fake_zju_big":
        # 1024^2 at ss=2 gives the same 4x4 ground-truth supersampling per
        # ratio-0.5 train pixel as ss=4 at 512^2; grid=32 makes the
        # per-frame blend-weight volumes large enough to matter
        print("writing data/fake_zju_big (5 views x 100 frames, 1024^2, "
              "6890 verts) ...")
        write_fake_dataset("data/fake_zju_big", n_frames=100, n_views=5,
                           n_verts=6890, H=1024, W=1024, supersample=2,
                           texture=True, grid=32)
    print("done")


if __name__ == "__main__":
    main()
