"""Read the JAX package's orbax checkpoints without orbax, tensorstore or jax.

``instant_nvr_tpu/train/checkpoint.py`` saves ``{params, opt_state, step,
meta}`` with ``orbax.checkpoint.StandardCheckpointer``: one zarr v2 array
per leaf, stored in tensorstore's OCDBT key-value store.  This module reads
that file set with numpy and the host library ``csrc/zstd.cpp`` (zstd,
CRC32C, XXH64; built with g++ at first use into ``build/torch_kernels/``
by ``utils/native.py:build_host_library`` and bound with ctypes, so a
decode runs without the interpreter lock).  A failed build raises; there
is no Python decoder to fall back to.

The layout, as orbax 0.11 and tensorstore 0.1 write it (tensorstore's own
reader was the oracle for every field below; ``tests/test_torch_orbax.py``
holds this reader to it):

An epoch directory holds
  - ``_CHECKPOINT_METADATA`` (JSON: the handler, timestamps);
  - ``_METADATA`` (JSON): ``use_ocdbt`` (true), ``use_zarr3`` (false) and
    ``tree_metadata``, which maps each leaf's key path, written as the str
    of a tuple, to ``{"key_metadata": [{"key", "key_type"}...],
    "value_metadata": {"value_type", "skip_deserialize", ...}}``.  Key type
    2 is a dict key (NamedTuples save as dicts of their fields), 1 a
    sequence index (tuples and lists).  Value types are ``jax.Array``,
    ``np.ndarray``, ``scalar`` or ``None``; a ``None`` leaf (optax's empty
    states) has ``skip_deserialize: true`` and no array;
  - ``_sharding`` and ``array_metadatas/process_<n>`` (JSON; not needed
    to read the values);
  - ``manifest.ocdbt`` and ``d/<hex>``: the OCDBT database the leaves are
    read from, and ``ocdbt.process_<n>/manifest.ocdbt`` and
    ``ocdbt.process_<n>/d/<hex>``: each writing process's own database,
    whose data files the root's B-tree refers to.

OCDBT files.  Integers are little-endian; a varint is LEB128 (7 bits a
byte, low first, at most 10 bytes).  A manifest and a B-tree node are
  magic (u32 big-endian: ``0c db 3a 2a`` manifest, ``0c db 20 de`` node),
  length (u64: the whole file or node, these 12 bytes and the CRC included),
  version (varint, 0), compression (varint: 0 none, 1 zstd),
  body (a zstd frame when compressed), CRC32C of everything before it (u32).
A data file table (in manifests and nodes) is
  count n; prefix_length[1..n-1] (shared with the previous full path);
  suffix_length[n]; base_path_length[n]; the suffixes, concatenated.
  Full path i = full path i-1 [:prefix_length[i]] + suffix i; its first
  base_path_length[i] bytes are the base path (``ocdbt.process_0/`` or
  empty), the rest the relative path (``d/<hex>``), both relative to the
  database's directory.
A manifest body is
  config: uuid (16 bytes), manifest_kind (varint, 0 = versions inline),
  max_inline_value_bytes, max_decoded_node_bytes (varints),
  version_tree_arity_log2 (u8), compression_method (varint; 1 = zstd,
  then the level as an i32);
  a data file table;
  the newest versions: count m; generation_number[m]; root_height[m] (u8);
  root data_file_id[m], offset[m], length[m]; num_keys[m],
  num_tree_bytes[m], num_indirect_value_bytes[m] (varints);
  commit_time[m] (u64 ns);
  then references to version-tree nodes of older generations, not read
  here: the newest generation, the one read, is always inline.  An empty
  database's root has offset and length 2^64-1.
A B-tree node body is
  height (u8; 0 = leaf); a data file table; entry count n;
  key_prefix_length[1..n-1] (shared with the previous key);
  key_suffix_length[n]; interior nodes only: subtree_common_prefix_length[n];
  the key suffixes, concatenated.  Then
  leaf:     value_length[n]; value_kind[n] (u8: 0 inline, 1 in a data file);
            for the out-of-line values, data_file_id[] and offset[];
            the inline values, concatenated.
  interior: child data_file_id[n], offset[n], length[n]; num_keys[n],
            num_tree_bytes[n], num_indirect_value_bytes[n].
  A key in a node is relative to the node's prefix: the root's is empty,
  and entry i's child has its parent's prefix plus the first
  subtree_common_prefix_length[i] bytes of key i.

Each leaf is a zarr v2 array under its key path joined by dots:
``<path>/.zarray`` (JSON: ``zarr_format`` 2, ``shape``, ``chunks``,
``dtype`` ``<f4``/``<i4``/``<i8``/``bfloat16``, ``compressor``
``{"id": "zstd", "level": 1}``, ``order`` "C", ``filters`` null,
``fill_value`` null, ``dimension_separator`` ".") and one chunk per
``<path>/<i>.<j>...`` (``<path>/0`` for a 0-d array): the C-order bytes of
a full chunk, zstd-compressed.  A single process writes one chunk per
array; several are read too.  Tensorstore's zstd frames of the chunks
state no content size (the size comes from ``.zarray``, and a chunk is
decoded straight into its array) and set no checksum; those of a small
tree hold raw and Huffman-coded literals, and larger ones multi-block
frames and treeless literals.

:func:`read_checkpoint` returns the tree as nested dicts, lists and
``None``, with numpy leaves (0-d arrays for scalars, as orbax's
``_restore_numpy`` gives them) and ``torch.bfloat16`` tensors for bfloat16
leaves.  Anything the layout above does not cover raises ``ValueError``
naming the file or the leaf.
"""
from __future__ import annotations

import ctypes
import json
import os
import struct
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Tuple, Union

import numpy as np
import torch

from ..utils import native

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "zstd.cpp"
MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
ZSTD_MAGIC = 0xFD2FB528
MISSING = 2 ** 64 - 1        # offset and length of an empty database's root
MAX_UNSIZED = 1 << 31        # largest output of frames that state no size
DTYPES = {"<f4": np.float32, "<i4": np.int32, "<i8": np.int64,
          "bfloat16": np.uint16}
VALUE_TYPES = ("jax.Array", "np.ndarray", "scalar", "None")
_ERRLEN = 512

_lock = threading.Lock()
_lib = None


# -- the host library ---------------------------------------------------------

def library_path() -> Path:
    return native.host_library_path(SOURCE)


def load() -> ctypes.CDLL:
    """The library, built and bound on first use (thread-safe)."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(native.build_host_library(SOURCE)))
            i64, vp = ctypes.c_int64, ctypes.c_void_p
            lib.zstd_content_size.restype = i64
            lib.zstd_content_size.argtypes = [vp, i64, ctypes.c_char_p, i64]
            lib.zstd_decompress.restype = i64
            lib.zstd_decompress.argtypes = [vp, i64, vp, i64, ctypes.c_char_p, i64]
            lib.crc32c.restype = ctypes.c_uint32
            lib.crc32c.argtypes = [vp, i64]
            lib.xxh64.restype = ctypes.c_uint64
            lib.xxh64.argtypes = [vp, i64, ctypes.c_uint64]
            _lib = lib
        return _lib


def _ptr(buf) -> Tuple[int, int, object]:
    """(address, length, keep-alive) of a bytes-like object."""
    a = np.frombuffer(buf, np.uint8) if not isinstance(buf, np.ndarray) else buf
    return a.ctypes.data, a.nbytes, a


def crc32c(data) -> int:
    addr, n, _keep = _ptr(data)
    return int(load().crc32c(addr, n))


def xxh64(data, seed: int = 0) -> int:
    addr, n, _keep = _ptr(data)
    return int(load().xxh64(addr, n, seed))


def content_size(data, name: str = "<bytes>") -> Optional[int]:
    """Total content size the zstd frames in ``data`` state; None when a
    frame does not state it."""
    addr, n, _keep = _ptr(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    r = load().zstd_content_size(addr, n, err, _ERRLEN)
    if r == -2:
        raise ValueError(f"{name}: {err.value.decode()}")
    return None if r < 0 else int(r)


class OutOfRoom(ValueError):
    """The decoded data do not fit the output buffer."""


def decompress_into(data, out: np.ndarray, name: str = "<bytes>") -> int:
    """Decode the zstd frames of ``data`` into the C-contiguous array
    ``out``; returns the bytes written.  Raises ``ValueError`` naming
    ``name`` when the data are malformed (:class:`OutOfRoom` when they do
    not fit)."""
    if not out.flags.c_contiguous:
        raise ValueError(f"{name}: output buffer is not contiguous")
    addr, n, _keep = _ptr(data)
    err = ctypes.create_string_buffer(_ERRLEN)
    r = load().zstd_decompress(addr, n, out.ctypes.data, out.nbytes, err, _ERRLEN)
    if r < 0:
        raise (OutOfRoom if r == -2 else ValueError)(f"{name}: {err.value.decode()}")
    return int(r)


def decompress(data, name: str = "<bytes>") -> bytes:
    """The decoded bytes of ``data``'s zstd frames."""
    size = content_size(data, name)
    cap = size if size is not None else max(4 * len(data), 1 << 16)
    while True:
        out = np.empty(cap, np.uint8)
        try:
            n = decompress_into(data, out, name)
            return out[:n].tobytes()
        except OutOfRoom:
            if size is not None or cap >= MAX_UNSIZED:
                raise
            cap = min(4 * cap, MAX_UNSIZED)   # no stated size: grow, retry


# -- OCDBT --------------------------------------------------------------------

class _Reader:
    """Bounds-checked reads of a decoded manifest or node body."""

    def __init__(self, body: bytes, name: str):
        self.b, self.pos, self.name = body, 0, name

    def fail(self, what: str):
        raise ValueError(f"{self.name}: {what} (at byte {self.pos})")

    def take(self, n: int) -> bytes:
        if n < 0 or n > len(self.b) - self.pos:
            self.fail("truncated")
        self.pos += n
        return self.b[self.pos - n:self.pos]

    def u8(self) -> int:
        return self.take(1)[0]

    def varint(self) -> int:
        v = 0
        for i in range(10):
            c = self.take(1)[0]
            v |= (c & 0x7F) << (7 * i)
            if c < 0x80:
                if v >= 2 ** 64:
                    self.fail("varint above 64 bits")
                return v
        self.fail("varint longer than 10 bytes")

    def varints(self, n: int) -> List[int]:
        return [self.varint() for _ in range(n)]

    def end(self):
        if self.pos != len(self.b):
            self.fail(f"{len(self.b) - self.pos} unread bytes")


def _unwrap(raw: bytes, magic: int, name: str) -> bytes:
    """The body of a manifest or node: check its magic, length, version and
    CRC32C, and decompress it."""
    if len(raw) < 18:
        raise ValueError(f"{name}: truncated ({len(raw)} bytes)")
    got_magic, length = struct.unpack_from(">I", raw)[0], struct.unpack_from("<Q", raw, 4)[0]
    if got_magic != magic:
        raise ValueError(f"{name}: magic {got_magic:08x}, expected {magic:08x}")
    if length != len(raw):
        raise ValueError(f"{name}: header states {length} bytes, found {len(raw)}")
    want = struct.unpack_from("<I", raw, len(raw) - 4)[0]
    if crc32c(memoryview(raw)[:-4]) != want:
        raise ValueError(f"{name}: CRC32C mismatch")
    hdr = _Reader(raw[12:-4], name)
    version, method = hdr.varint(), hdr.varint()
    if version != 0:
        raise ValueError(f"{name}: format version {version} (only 0 is read)")
    body = raw[12 + hdr.pos:-4]
    if method == 0:
        return body
    if method == 1:
        return decompress(body, name)
    raise ValueError(f"{name}: compression method {method} (0 or 1 are read)")


def _data_file_table(r: _Reader) -> List[str]:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix, base = r.varints(n), r.varints(n)
    paths, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("data file path prefix longer than the previous path")
        full = prev[:prefix[i]] + r.take(suffix[i])
        if base[i] > len(full):
            r.fail("base path longer than the path")
        paths.append(full.decode())
        prev = full
    return paths


def _keys(r: _Reader, n: int, interior: bool) -> Tuple[List[bytes], List[int]]:
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else []
    keys, prev = [], b""
    for i in range(n):
        if prefix[i] > len(prev):
            r.fail("key prefix longer than the previous key")
        k = prev[:prefix[i]] + r.take(suffix[i])
        if keys and k <= keys[-1]:
            r.fail("keys out of order")
        if interior and common[i] > len(k):
            r.fail("subtree common prefix longer than the key")
        keys.append(k)
        prev = k
    return keys, common


class ValueRef(tuple):
    """(relative file path, offset, length) of an out-of-line value."""


class OcdbtStore:
    """The newest version of the OCDBT database in directory ``root``: every
    key with its value (inline bytes or a :class:`ValueRef`), read from the
    manifest and the B-tree nodes at construction; values are read on
    demand."""

    def __init__(self, root: str):
        self.root = os.path.abspath(root)
        self.entries: Dict[bytes, Union[bytes, ValueRef]] = {}
        name = os.path.join(self.root, "manifest.ocdbt")
        with open(name, "rb") as f:
            raw = f.read()
        r = _Reader(_unwrap(raw, MANIFEST_MAGIC, name), name)
        r.take(16)                                    # uuid
        kind = r.varint()
        if kind != 0:
            r.fail(f"manifest kind {kind} (only 0, versions inline, is read)")
        r.varints(2)                                  # inline value, node limits
        r.u8()                                        # version tree arity
        if r.varint() == 1:
            r.take(4)                                 # zstd level
        files = _data_file_table(r)
        m = r.varint()
        if m == 0:
            r.fail("manifest lists no version")
        r.varints(m)                                  # generation numbers
        heights = [r.u8() for _ in range(m)]
        fid, off, length = r.varints(m), r.varints(m), r.varints(m)
        for _ in range(3):
            r.varints(m)                              # statistics
        r.take(8 * m)                                 # commit times
        if off[-1] == MISSING and length[-1] == MISSING:
            return                                    # an empty database
        if fid[-1] >= len(files):
            r.fail(f"root data file id {fid[-1]} of {len(files)}")
        self._node(files[fid[-1]], off[-1], length[-1], heights[-1], b"")

    def _path(self, rel: str) -> str:
        parts = rel.split("/")
        if not rel or rel.startswith("/") or ".." in parts:
            raise ValueError(f"{self.root}: data file path {rel!r} leaves the database")
        return os.path.join(self.root, *parts)

    def _range(self, rel: str, offset: int, length: int) -> bytes:
        path = self._path(rel)
        with open(path, "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if offset > size or length > size - offset:
                raise ValueError(f"{path}: range [{offset}, +{length}) beyond "
                                 f"its {size} bytes")
            f.seek(offset)
            return f.read(length)

    def _node(self, rel: str, offset: int, length: int, height: int, prefix: bytes):
        name = f"{self._path(rel)}@{offset}"
        r = _Reader(_unwrap(self._range(rel, offset, length), NODE_MAGIC, name), name)
        if r.u8() != height:
            r.fail(f"node height differs from its parent's reference ({height})")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            r.fail("node without entries")
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            fid, off, lens = r.varints(n), r.varints(n), r.varints(n)
            for _ in range(3):
                r.varints(n)                          # statistics
            r.end()
            for i in range(n):
                if fid[i] >= len(files):
                    r.fail(f"child data file id {fid[i]} of {len(files)}")
                self._node(files[fid[i]], off[i], lens[i], height - 1,
                           prefix + keys[i][:common[i]])
            return
        lens = r.varints(n)
        kinds = list(r.take(n))
        if any(k > 1 for k in kinds):
            r.fail("value kind other than 0 (inline) or 1 (data file)")
        out_of_line = [i for i in range(n) if kinds[i]]
        fid, off = r.varints(len(out_of_line)), r.varints(len(out_of_line))
        refs = dict(zip(out_of_line, zip(fid, off)))
        for i in range(n):
            if kinds[i]:
                f, o = refs[i]
                if f >= len(files):
                    r.fail(f"value data file id {f} of {len(files)}")
                self.entries[prefix + keys[i]] = ValueRef((files[f], o, lens[i]))
            else:
                self.entries[prefix + keys[i]] = r.take(lens[i])
        r.end()

    def keys(self) -> List[bytes]:
        return sorted(self.entries)

    def source(self, key: bytes) -> str:
        """Where ``key``'s value lies: its data file and offset, or inline."""
        v = self.entries[key]
        return f"{self._path(v[0])}@{v[1]}" if isinstance(v, ValueRef) else "inline"

    def read(self, key: bytes) -> bytes:
        if key not in self.entries:
            raise KeyError(f"{self.root}: no key {key.decode(errors='replace')!r}")
        v = self.entries[key]
        if isinstance(v, ValueRef):
            return self._range(*v)
        return v


# -- zarr v2 ------------------------------------------------------------------

def _zarray(store: OcdbtStore, leaf: str) -> dict:
    where = f"{store.root}: leaf {leaf}"
    try:
        meta = json.loads(store.read(f"{leaf}/.zarray".encode()))
    except KeyError:
        raise ValueError(f"{where}: no .zarray") from None
    except json.JSONDecodeError as e:
        raise ValueError(f"{where}: .zarray is not JSON ({e})") from None
    comp = meta.get("compressor")
    checks = [
        (meta.get("zarr_format") == 2, f"zarr_format {meta.get('zarr_format')}"),
        (meta.get("dtype") in DTYPES, f"dtype {meta.get('dtype')!r}"),
        (comp is None or comp.get("id") == "zstd", f"compressor {comp}"),
        (meta.get("order") == "C", f"order {meta.get('order')!r}"),
        (not meta.get("filters"), f"filters {meta.get('filters')}"),
        (meta.get("dimension_separator", ".") in (".", "/"),
         f"dimension_separator {meta.get('dimension_separator')!r}"),
        (len(meta.get("shape", ())) == len(meta.get("chunks", ()))
         and all(c > 0 for c in meta.get("chunks", ())),
         f"chunks {meta.get('chunks')} for shape {meta.get('shape')}"),
    ]
    for ok, what in checks:
        if not ok:
            raise ValueError(f"{where}: unsupported {what}")
    return meta


def _chunk_into(store: OcdbtStore, key: bytes, compressed: bool, out: np.ndarray,
                where: str) -> None:
    data = store.read(key)
    if compressed:
        n = decompress_into(data, out.reshape(-1).view(np.uint8), where)
    else:
        n = len(data)
        if n == out.nbytes:
            out.reshape(-1).view(np.uint8)[:] = np.frombuffer(data, np.uint8)
    if n != out.nbytes:
        raise ValueError(f"{where}: chunk holds {n} bytes, expected {out.nbytes}")


def read_array(store: OcdbtStore, leaf: str) -> Union[np.ndarray, torch.Tensor]:
    """The zarr v2 array ``leaf`` of ``store``: a numpy array, or a
    ``torch.bfloat16`` tensor for bfloat16.  A single chunk is decoded
    straight into the returned array."""
    meta = _zarray(store, leaf)
    shape, chunks = tuple(meta["shape"]), tuple(meta["chunks"])
    dtype = np.dtype(DTYPES[meta["dtype"]])
    compressed = meta.get("compressor") is not None
    sep = meta.get("dimension_separator", ".")
    out = np.empty(shape, dtype)
    grid = [-(-s // c) for s, c in zip(shape, chunks)]
    for idx in np.ndindex(*grid):
        key = (f"{leaf}/" + (sep.join(map(str, idx)) if idx else "0")).encode()
        where = f"{store.root}: leaf {leaf} chunk {key.decode()}"
        if key not in store.entries:
            if meta.get("fill_value") is None:
                raise ValueError(f"{where}: missing, and the array has no fill value")
            region = tuple(slice(i * c, min((i + 1) * c, s))
                           for i, c, s in zip(idx, chunks, shape))
            out[region] = meta["fill_value"]
            continue
        where += f" ({store.source(key)})"
        if chunks == shape:
            _chunk_into(store, key, compressed, out, where)
            continue
        buf = np.empty(chunks, dtype)
        _chunk_into(store, key, compressed, buf, where)
        region = tuple(slice(i * c, min((i + 1) * c, s))
                       for i, c, s in zip(idx, chunks, shape))
        out[region] = buf[tuple(slice(0, r.stop - r.start) for r in region)]
    if meta["dtype"] == "bfloat16":
        return torch.from_numpy(out).view(torch.bfloat16)
    return out


# -- the tree -----------------------------------------------------------------

def is_orbax_dir(path: str) -> bool:
    """Whether ``path`` holds the JAX package's orbax layout."""
    return (os.path.isfile(os.path.join(path, "_CHECKPOINT_METADATA"))
            and os.path.isfile(os.path.join(path, "manifest.ocdbt")))


def _tree_metadata(path: str) -> List[Tuple[List[str], List[int], dict]]:
    """``_METADATA``'s leaves: (keys, key types, value metadata) each."""
    name = os.path.join(path, "_METADATA")
    with open(name) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{name}: only OCDBT with zarr v2 is read "
                         f"(use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')})")
    if not isinstance(meta.get("tree_metadata"), dict):
        raise ValueError(f"{name}: no tree_metadata")
    out = []
    for entry in meta["tree_metadata"].values():
        km = entry["key_metadata"]
        out.append(([str(k["key"]) for k in km], [int(k["key_type"]) for k in km],
                    entry["value_metadata"]))
    return out


def _build(node: dict, path: str):
    """Nested {key: (type, child)} -> dicts and lists."""
    types = {t for t, _ in node.values()}
    if types == {1}:
        idx = sorted(int(k) for k in node)
        if idx != list(range(len(idx))):
            raise ValueError(f"{path}: sequence indices {idx} are not 0..{len(idx) - 1}")
        return [_build_child(node[str(i)][1], f"{path}.{i}") for i in idx]
    if types != {2}:
        raise ValueError(f"{path}: mixed or unknown key types {sorted(types)}")
    return {k: _build_child(v, f"{path}.{k}" if path else k) for k, (_, v) in node.items()}


def _build_child(child, path):
    return _build(child, path) if isinstance(child, dict) else child[0]


def leaves(tree, path: Tuple[str, ...] = ()):
    """(key path, key types, leaf) of a tree of dicts and lists, in jax's
    flattening order (dict keys sorted), as orbax lists them; key type 2 is
    a dict key, 1 a sequence index."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            for p, t, v in leaves(tree[k], path + (k,)):
                yield p, (2,) + t, v
    elif isinstance(tree, (list, tuple)):
        for i, x in enumerate(tree):
            for p, t, v in leaves(x, path + (str(i),)):
                yield p, (1,) + t, v
    else:
        yield path, (), tree


def read_checkpoint(path: str, prefixes: Optional[Iterable[str]] = ("params",)):
    """The tree of the orbax checkpoint at ``path`` (an epoch directory),
    restricted to the top-level keys in ``prefixes`` (None: all).  Leaves
    outside them are never read or decompressed."""
    want = None if prefixes is None else set(prefixes)
    leaves = [lf for lf in _tree_metadata(path) if want is None or lf[0][0] in want]
    store = None
    root: dict = {}
    for keys, types, vmeta in leaves:
        leaf = ".".join(keys)
        vtype = vmeta.get("value_type")
        if vtype not in VALUE_TYPES:
            raise ValueError(f"{path}: leaf {leaf} has value type {vtype!r}")
        if vmeta.get("skip_deserialize") or vtype == "None":
            value = None
        else:
            if store is None:
                store = OcdbtStore(path)
            value = read_array(store, leaf)
        node = root
        for k, t in zip(keys[:-1], types[:-1]):
            if k in node and not isinstance(node[k][1], dict):
                raise ValueError(f"{path}: leaf {leaf} lies under another leaf")
            node = node.setdefault(k, (t, {}))[1]
        if keys[-1] in node:
            raise ValueError(f"{path}: leaf {leaf} appears twice")
        node[keys[-1]] = (types[-1], (value,))
    if want is not None and not want <= set(root):
        raise ValueError(f"{path}: no {sorted(want - set(root))} in the checkpoint")
    return _build(root, "") if root else {}
