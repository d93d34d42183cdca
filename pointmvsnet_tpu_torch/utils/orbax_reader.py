"""The JAX package's orbax checkpoints, read with numpy alone.

``pointmvsnet_tpu/utils/checkpoint.py`` saves a TrainState with orbax's
``StandardCheckpointer`` (orbax-checkpoint 0.11): an OCDBT key-value store
(tensorstore's "OCDBT" format) of zarr v2 arrays whose chunks are zstd
frames. The port runs where neither orbax, tensorstore nor a zstd module
is installed, so this module decodes that layout itself:

- ``_METADATA`` (JSON) names every leaf of the saved tree;
- ``manifest.ocdbt`` holds the store's configuration and its versions;
  the newest version points at the root of a b-tree;
- the b-tree's nodes (in data files under ``d/`` and
  ``ocdbt.process_<n>/d/``) map keys such as
  ``params.img_conv.ConvBlock_0.Conv_0.kernel/.zarray`` and ``…/0.0.0.0``
  to values stored inline or as (data file, offset, length);
- each leaf's ``.zarray`` gives its shape, dtype and chunk grid, and each
  chunk is a zstd frame (``utils/zstd.py``) of the chunk's C-order bytes.

Manifests and nodes are checked against their CRC-32C. ``read_orbax``
returns ``{"params/…": ndarray, "batch_stats/…": …, "step": …,
"opt_state/…": …}``, the flat layout ``utils/convert.py::jax_to_torch``
takes. Anything outside what the JAX package writes (zarr v3, a store
that is not OCDBT, numbered manifests, an unknown dtype, compressor,
filter or order) raises ``ValueError`` naming the path or key.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Iterable, Optional

import numpy as np

from pointmvsnet_tpu_torch.utils import zstd

_MANIFEST_MAGIC, _NODE_MAGIC = 0x0CDB3A2A, 0x0CDB20DE
# zarr v2 dtypes orbax writes for the JAX package's states; bfloat16 is
# widened to float32 (exactly), since numpy has no bfloat16
_DTYPES = ("<f4", "<f2", "<i4", "<i8", "|b1", "bfloat16")


def _crc32c_table():
    table = []
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (0x82F63B78 if c & 1 else 0)
        table.append(c)
    return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
    c = 0xFFFFFFFF
    for b in data:
        c = _CRC32C[(c ^ b) & 0xFF] ^ (c >> 8)
    return c ^ 0xFFFFFFFF


class _Reader:
    """Forward reader of an OCDBT body: varints, fixed-width integers, bytes."""

    def __init__(self, data: bytes, where: str):
        self.data, self.pos, self.where = data, 0, where

    def fail(self, what: str):
        return ValueError(f"{self.where}: {what}")

    def bytes(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise self.fail("ends early")
        out = self.data[self.pos:self.pos + n]
        self.pos += n
        return out

    def uint(self, n: int) -> int:
        return int.from_bytes(self.bytes(n), "little")

    def varint(self) -> int:
        value, shift = 0, 0
        while True:
            b = self.bytes(1)[0]
            value |= (b & 0x7F) << shift
            if b < 0x80:
                return value
            shift += 7
            if shift > 63:
                raise self.fail("varint longer than 64 bits")

    def varints(self, n: int) -> list:
        return [self.varint() for _ in range(n)]


def _unwrap(data: bytes, magic: int, where: str) -> _Reader:
    """Check an OCDBT file's header and CRC-32C footer; → a reader of its
    (decompressed) body."""
    r = _Reader(data, where)
    if len(data) < 18 or int.from_bytes(data[:4], "big") != magic:
        raise r.fail(f"not an OCDBT {'manifest' if magic == _MANIFEST_MAGIC else 'node'}")
    r.pos = 4
    if r.uint(8) != len(data):
        raise r.fail("length field disagrees with the size")
    version, compression = r.varint(), r.varint()
    if version != 0 or compression > 1:
        raise r.fail(f"unsupported version {version} / compression {compression}")
    if crc32c(data[:-4]) != int.from_bytes(data[-4:], "little"):
        raise r.fail("CRC-32C mismatch")
    body = data[r.pos:-4]
    return _Reader(zstd.decompress(body) if compression else body, where)


def _data_file_table(r: _Reader) -> list:
    n = r.varint()
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    r.varints(n)                                      # base path lengths: part of the path
    paths, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.bytes(s)
        paths.append(prev.decode())
    return paths


def _keys(r: _Reader, n: int, interior: bool):
    """A node's prefix-compressed keys → (keys, each interior entry's
    subtree common prefix length)."""
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    common = r.varints(n) if interior else None
    keys, prev = [], b""
    for p, s in zip(prefix, suffix):
        prev = prev[:p] + r.bytes(s)
        keys.append(prev)
    return keys, common


class _Store:
    """An OCDBT store rooted at a directory: its newest version's keys."""

    def __init__(self, root: str):
        self.root = root
        self._files: Dict[str, bytes] = {}
        r = _unwrap(self._file("manifest.ocdbt"), _MANIFEST_MAGIC,
                    os.path.join(root, "manifest.ocdbt"))
        r.bytes(16)                                   # uuid
        kind = r.varint()
        r.varints(2)                                  # max inline value / decoded node bytes
        r.bytes(1)                                    # version tree arity log2
        if r.varint() == 1:                           # zstd for nodes: its level
            r.bytes(4)
        if kind != 0:
            raise r.fail("numbered manifests are not supported (only the single kind)")
        files = _data_file_table(r)
        n = r.varint()
        if n == 0:
            raise r.fail("no version in the manifest")
        r.varints(n)                                  # generation numbers
        heights = list(r.bytes(n))
        ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
        # the inline versions end with the newest
        self.entries: Dict[bytes, object] = {}
        self._node(files[ids[-1]], offsets[-1], lengths[-1], heights[-1], b"")

    def _file(self, rel: str) -> bytes:
        if rel not in self._files:
            path = os.path.join(self.root, rel)
            if not os.path.isfile(path):
                raise ValueError(f"{self.root}: OCDBT file {rel!r} is missing")
            with open(path, "rb") as f:
                self._files[rel] = f.read()
        return self._files[rel]

    def _slice(self, rel: str, offset: int, length: int) -> bytes:
        data = self._file(rel)
        if offset + length > len(data):
            raise ValueError(f"{self.root}: {rel!r} holds {len(data)} bytes, "
                             f"{length} wanted at {offset}")
        return data[offset:offset + length]

    def _node(self, rel: str, offset: int, length: int, height: int, prefix: bytes):
        where = f"{os.path.join(self.root, rel)}@{offset}"
        r = _unwrap(self._slice(rel, offset, length), _NODE_MAGIC, where)
        if r.bytes(1)[0] != height:
            raise r.fail(f"node height differs from its reference ({height})")
        files = _data_file_table(r)
        n = r.varint()
        keys, common = _keys(r, n, height > 0)
        if height > 0:
            ids, offsets, lengths = r.varints(n), r.varints(n), r.varints(n)
            for key, c, i, o, ln in zip(keys, common, ids, offsets, lengths):
                self._node(files[i], o, ln, height - 1, prefix + key[:c])
            return
        sizes, kinds = r.varints(n), r.varints(n)
        indirect = [j for j, k in enumerate(kinds) if k == 1]
        if any(k > 1 for k in kinds):
            raise r.fail("unknown value kind")
        ids, offsets = r.varints(len(indirect)), r.varints(len(indirect))
        refs = dict(zip(indirect, zip(ids, offsets)))
        for j, (key, size) in enumerate(zip(keys, sizes)):
            if j in refs:
                i, o = refs[j]
                self.entries[prefix + key] = (files[i], o, size)
            else:
                self.entries[prefix + key] = r.bytes(size)

    def get(self, key: str) -> Optional[bytes]:
        v = self.entries.get(key.encode())
        if v is None or isinstance(v, bytes):
            return v
        return self._slice(*v)


def resolve(path: str) -> str:
    """The item directory of ``path`` as ``pointmvsnet_tpu/utils/
    checkpoint.py::Checkpointer.load`` resolves it: a manager root gives its
    newest integer step, a step directory its ``default/``, else the
    directory itself."""
    path = os.path.abspath(path)
    steps = sorted(int(d) for d in os.listdir(path) if d.isdigit()) if os.path.isdir(path) else []
    if steps:
        path = os.path.join(path, str(steps[-1]))
    if os.path.isdir(os.path.join(path, "default")):
        path = os.path.join(path, "default")
    return path


def is_orbax(path: str) -> bool:
    """A directory holding integer step directories, ``_CHECKPOINT_METADATA``
    or ``manifest.ocdbt`` (a directory of the port's ``<epoch>.pt`` files
    holds none of them)."""
    return os.path.isdir(path) and any(
        d.isdigit() or d in ("_CHECKPOINT_METADATA", "manifest.ocdbt") for d in os.listdir(path))


def _fill(value, dtype) -> np.ndarray:
    if value is None:
        return np.zeros((), dtype)
    if isinstance(value, str):                        # "NaN", "Infinity", "-Infinity"
        value = float(value.replace("Infinity", "inf"))
    return np.asarray(value, dtype)


def _array(store: _Store, zkey: str, name: str) -> np.ndarray:
    meta = store.get(zkey + "/.zarray")
    if meta is None:
        raise ValueError(f"{store.root}: no array stored for {name!r}")
    z = json.loads(meta)
    spelled = z.get("dtype")
    if z.get("zarr_format") != 2 or spelled not in _DTYPES:
        raise ValueError(f"{store.root}: {name!r} has dtype {spelled!r} (zarr format "
                         f"{z.get('zarr_format')}); supported: {sorted(_DTYPES)}")
    compressor = (z.get("compressor") or {}).get("id")
    if compressor not in (None, "zstd") or z.get("filters") or z.get("order") != "C":
        raise ValueError(f"{store.root}: {name!r} uses compressor {compressor!r}, filters "
                         f"{z.get('filters')!r}, order {z.get('order')!r}; supported: zstd "
                         f"or none, no filters, C order")
    bf16 = spelled == "bfloat16"
    dtype = np.dtype(np.float32 if bf16 else spelled)
    shape, chunks = tuple(z["shape"]), tuple(z["chunks"])
    sep = z.get("dimension_separator", ".")
    out = np.full(shape, _fill(z.get("fill_value"), dtype), dtype)
    for idx in np.ndindex(*(-(-s // c) for s, c in zip(shape, chunks))):
        data = store.get(f"{zkey}/{sep.join(map(str, idx)) if idx else '0'}")
        if data is None:
            continue                                  # a missing chunk is fill_value
        if compressor:
            data = zstd.decompress(data)
        chunk = np.frombuffer(data, np.uint16 if bf16 else dtype)
        if chunk.size != int(np.prod(chunks)):
            raise ValueError(f"{store.root}: chunk {idx} of {name!r} holds {chunk.size} "
                             f"values, not {int(np.prod(chunks))}")
        if bf16:
            chunk = (chunk.astype(np.uint32) << 16).view(np.float32)
        chunk = chunk.reshape(chunks)
        sl = tuple(slice(i * c, min((i + 1) * c, s)) for i, c, s in zip(idx, chunks, shape))
        out[sl] = chunk[tuple(slice(0, s.stop - s.start) for s in sl)]
    return out


def read_orbax(path: str, keys: Optional[Iterable[str]] = None) -> Dict[str, np.ndarray]:
    """The arrays of an orbax checkpoint written by the JAX package →
    ``{"params/img_conv/…/kernel": ndarray, …}``. ``path``: a manager root,
    a step directory or an item directory (``resolve``). ``keys``: decode
    only the leaves whose name starts with one of these (``"params/"``,
    ``"batch_stats/"``, ``"step"``, …). bfloat16 leaves come back as
    float32 of the same values."""
    item = resolve(path)
    meta_path = os.path.join(item, "_METADATA")
    if not os.path.isfile(meta_path):
        raise ValueError(f"{item}: no _METADATA; not an orbax checkpoint of the JAX package")
    with open(meta_path) as f:
        meta = json.load(f)
    if not meta.get("use_ocdbt", False) or meta.get("use_zarr3", False):
        raise ValueError(f"{meta_path}: use_ocdbt={meta.get('use_ocdbt')}, "
                         f"use_zarr3={meta.get('use_zarr3')}; only OCDBT with zarr v2 is read")
    prefixes = tuple(keys) if keys is not None else ("",)
    store, out = None, {}
    for leaf in meta["tree_metadata"].values():
        parts = [str(k["key"]) for k in leaf["key_metadata"]]
        name = "/".join(parts)
        value = leaf["value_metadata"]
        if value.get("skip_deserialize") or not name.startswith(prefixes):
            continue
        if value.get("value_type") not in ("np.ndarray", "jax.Array", "scalar"):
            raise ValueError(f"{meta_path}: {name!r} is a {value.get('value_type')!r}, "
                             f"not an array")
        store = store or _Store(item)
        out[name] = _array(store, ".".join(parts), name)
    return out
