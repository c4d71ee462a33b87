"""Checkpoints: ``repro/checkpoint/manager.py``, in the reference's file layout.

A file is ``RPRCKPT2``, a little-endian u64 header length, a JSON header
``{"meta": ..., "index": [{"key", "shape", "dtype", "offset", "nbytes",
"crc"}]}`` and the leaves' compressed blobs (``offset`` from the end of the
header).  ``crc`` is the crc32 of a leaf's raw bytes; ``key`` is its path as
the reference's ``_flatten_with_paths`` spells it: dict keys in sorted
order, list and tuple positions as numbers, a NamedTuple's fields as
``.name`` (``(params, AdamWState)`` gives ``0/embed``, ``1/.step``,
``1/.mu/embed``, ...).  A checkpoint the reference writes restores into
the port's tree; the reference reads the port's files where it runs without
``zstandard`` (it then decodes zlib, and only zlib).

* Leaves are written with ``zlib`` (level 3, the reference's fallback
  where ``zstandard`` does not import).  A zstd frame (the reference's
  choice where it does) is recognised by its magic bytes and decoded where
  ``zstandard`` imports; elsewhere reading it raises an error that names
  the leaf.  Blobs are compressed and decompressed on a pool of threads
  (``zlib`` releases the GIL) of half the host's cores, so that an async
  save leaves the train loop's host thread room; the file's order is kept.
* bfloat16 leaves, which numpy has no type for, are written as their raw
  2-byte words under the dtype name ``bfloat16``, as the reference's
  ``ml_dtypes`` arrays are, and read back bit for bit.
* A file is written to ``<path>.tmp``, flushed, ``fsync``-ed and renamed
  (POSIX-atomic), so a crash never leaves a torn checkpoint at ``path``.
* :class:`CheckpointManager` saves on a thread over a host snapshot (the
  ``.cpu()`` copies are taken before the thread starts), keeps the newest
  ``keep`` files (older ones renamed to ``.trash``, then unlinked) and
  restores the newest, or a given step, onto ``device=`` (the port's
  counterpart of the reference's ``shardings=``).
"""
from __future__ import annotations

import json
import os
import re
import struct
import threading
import zlib
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

__all__ = ["CheckpointManager", "flatten_with_paths", "load_pytree", "save_pytree"]

_MAGIC = b"RPRCKPT2"
_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_POOL = max(1, (os.cpu_count() or 2) // 2)


def flatten_with_paths(tree, prefix: str = "") -> list[tuple[str, Any]]:
    """``(key, leaf)`` pairs in the reference's order and spelling (module docstring)."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = [(f".{name}", getattr(tree, name)) for name in tree._fields]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out: list = []
    for name, val in items:
        out.extend(flatten_with_paths(val, f"{prefix}/{name}" if prefix else name))
    return out


def _unflatten(tree, leaves):
    """``tree``'s structure with its leaves, in :func:`flatten_with_paths`
    order, taken from the iterator ``leaves``."""
    if isinstance(tree, dict):
        new = {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
        return {k: new[k] for k in tree}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_unflatten(getattr(tree, n), leaves) for n in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_unflatten(v, leaves) for v in tree)
    return next(leaves)


def _host_array(leaf) -> tuple[np.ndarray, list, str]:
    """(raw bytes as a flat uint8 array, shape, dtype name) of a tensor or
    array leaf: a view of the host copy, not a second copy made while
    holding the GIL."""
    if torch.is_tensor(leaf):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().reshape(-1).view(np.uint8), list(t.shape), \
                "bfloat16"
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return np.ascontiguousarray(arr.reshape(-1)).view(np.uint8), list(arr.shape), str(arr.dtype)


def _decompress(blob: bytes, key: str, path: str) -> bytes:
    if blob[:4] == _ZSTD_MAGIC:
        try:
            import zstandard
        except ImportError as e:
            raise RuntimeError(f"checkpoint {path}: leaf {key!r} is zstd-compressed and "
                               f"the zstandard package is not installed") from e
        return zstandard.ZstdDecompressor().decompress(blob)
    return zlib.decompress(blob)


def _tensor(raw: bytes, dtype: str, shape) -> torch.Tensor:
    if dtype == "bfloat16":
        arr = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(arr.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.frombuffer(raw, dtype=np.dtype(dtype)).reshape(shape).copy())


def save_pytree(tree, path: str, meta: dict | None = None) -> None:
    """Write a tree of tensors (or numpy arrays) to ``path`` atomically."""
    leaves = [(key, *_host_array(leaf)) for key, leaf in flatten_with_paths(tree)]
    with ThreadPoolExecutor(_POOL) as pool:
        blobs = list(pool.map(lambda x: zlib.compress(x[1], 3), leaves))
        crcs = list(pool.map(lambda x: zlib.crc32(x[1]) & 0xFFFFFFFF, leaves))
    index, offset = [], 0
    for (key, raw, shape, dtype), blob, crc in zip(leaves, blobs, crcs):
        index.append({"key": key, "shape": shape, "dtype": dtype, "offset": offset,
                      "nbytes": len(blob), "crc": crc})
        offset += len(blob)
    header = json.dumps({"meta": meta or {}, "index": index}).encode()
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<Q", len(header)))
        f.write(header)
        for blob in blobs:
            f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)


def _read(path: str) -> tuple[dict, dict]:
    """Every leaf of the file as a CPU tensor by key, crc-checked, and the meta."""
    with open(path, "rb") as f:
        if f.read(8) != _MAGIC:
            raise ValueError(f"bad checkpoint magic in {path}")
        (hlen,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(hlen))
        base = f.tell()
        entries = header["index"]
        blobs = []
        for ent in entries:
            f.seek(base + ent["offset"])
            blobs.append(f.read(ent["nbytes"]))

    def one(args):
        ent, blob = args
        raw = _decompress(blob, ent["key"], path)
        if zlib.crc32(raw) & 0xFFFFFFFF != ent["crc"]:
            raise ValueError(f"crc mismatch for {ent['key']} in {path}")
        return _tensor(raw, ent["dtype"], ent["shape"])

    with ThreadPoolExecutor(_POOL) as pool:
        tensors = list(pool.map(one, zip(entries, blobs)))
    return {ent["key"]: t for ent, t in zip(entries, tensors)}, header["meta"]


def load_pytree(path: str, target_tree=None, device=None):
    """Load a checkpoint; returns ``(tree, meta)``.

    Without ``target_tree`` the tree is ``{key: CPU tensor}``.  With it (a
    tree of the structure that was saved), each leaf becomes a tensor of the
    target leaf's type on ``device`` (default: a tensor target's device, or
    the CPU)."""
    leaves, meta = _read(path)
    if target_tree is None:
        return leaves, meta
    out = []
    for key, tgt in flatten_with_paths(target_tree):
        if key not in leaves:
            raise KeyError(f"checkpoint {path} missing leaf {key!r}")
        t = leaves[key]
        if tuple(t.shape) != tuple(tgt.shape):
            raise ValueError(f"shape mismatch for {key}: ckpt {tuple(t.shape)} vs target "
                             f"{tuple(tgt.shape)}")
        if torch.is_tensor(tgt):
            t = t.to(device=tgt.device if device is None else device, dtype=tgt.dtype)
        elif device is not None:
            t = t.to(device)
        out.append(t)
    return _unflatten(target_tree, iter(out)), meta


@dataclass
class CheckpointManager:
    """Directory-of-checkpoints manager with retention and async saves."""

    directory: str
    keep: int = 3

    def __post_init__(self):
        os.makedirs(self.directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._error: Exception | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"step_{step:08d}.ckpt")

    def steps(self) -> list[int]:
        out = []
        for name in os.listdir(self.directory):
            m = re.match(r"step_(\d+)\.ckpt$", name)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, meta: dict | None = None, block: bool = True):
        """Save ``tree`` as step ``step``; the host snapshot is taken before
        this returns, the file written on a thread (``block=False``)."""
        meta = dict(meta or {}, step=step)
        self.wait()
        snapshot = _unflatten(tree, iter(
            leaf.detach().to("cpu", copy=True) if torch.is_tensor(leaf) else np.array(leaf)
            for _, leaf in flatten_with_paths(tree)))

        def work():
            try:
                save_pytree(snapshot, self._path(step), meta)
                self._gc()
            except Exception as e:  # raised again by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()
        if block:
            self.wait()

    def wait(self):
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def restore(self, target_tree=None, device=None, step: int | None = None):
        step = step if step is not None else self.latest_step()
        if step is None:
            return None, None
        return load_pytree(self._path(step), target_tree, device)

    def _gc(self):
        for s in self.steps()[: -self.keep]:
            victim = self._path(s)
            trash = victim + ".trash"
            try:
                os.rename(victim, trash)
                os.unlink(trash)
            except OSError:
                pass
