"""Checkpointing: a JSON manifest and compressed raw leaves, one file each.

The port's counterpart of ``repro/checkpoint/checkpointer.py``, with its
guarantees:

  * ATOMIC — a save lands in ``step_<n>.tmp`` and is renamed to
    ``step_<n>`` only after the manifest, with a checksum of every leaf, is
    fsync'd; a crash mid-save never corrupts the latest valid checkpoint,
    and a ``.tmp`` directory is never restored.
  * CHECKED — each leaf's raw bytes carry a sha256 (first 16 hex digits);
    ``restore`` refuses a leaf whose bytes do not match.
  * ASYNC — ``Checkpointer.save_async`` copies every leaf to host memory
    before its writer thread starts, so the train loop waits only for the
    device-to-host copies, and the state may change under the writer.
  * SELF-DESCRIBING — tree paths, shapes, dtypes, the step, the codec and a
    format version live in the manifest.

The codec is zstd where ``zstandard`` imports and zlib otherwise, recorded
in the manifest (a zlib checkpoint takes version 3, a zstd one 2, as the
reference's).  ``codec="raw"`` stores the bytes as they are (version 3):
for multi-GB states, whose fp32 leaves zlib shrinks by ~7% at ~16 MB/s a
core, so that an AdamW state of a 1B-parameter model would take minutes
to save.  A save or restore hashes and (de)compresses its leaves on a pool
of threads (hashlib and the codecs release the interpreter lock).  Two
differences from the reference: the manifest is JSON
(``manifest.json``), since the card's machine has no ``msgpack``; and numpy
has no bfloat16, so a bf16 leaf is stored as its uint16 bits under
``"dtype": "bfloat16"`` and restored bit for bit.  Reading the reference's
msgpack checkpoints is not supported.

A state is a nested dict (or a dataclass such as ``TrainState``, whose
fields are its keys) of tensors, numpy arrays or numbers; leaves are keyed
by their path, ``"params/layers/attn/wq/a"``.  ``restore`` rebuilds the
template's structure; a tensor leaf of the template comes back on the
template's device with the template's strides, so a factor leaf stored with
padded rows keeps them.

A sharded state (each rank holding its blocks, ``runtime/distributed.py``)
saves with ``shardings=``: every rank calls :func:`save`, the blocks go to
rank 0 through the host, and rank 0 writes the whole leaves in the same
format.  ``restore(..., shardings=)`` is the elastic path: each rank reads
the whole leaves on the host and keeps its block under the shardings
given, on a mesh that may differ from the one that saved
(``fault_tolerance.ElasticReshard``).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Mapping, Optional

import numpy as np
import torch

from repro_torch.runtime.distributed import NamedSharding, assemble, gather_to_first
from repro_torch.runtime.fault_tolerance import ElasticReshard

try:  # optional dependency: zlib where zstandard is absent
    import zstandard
except ImportError:  # pragma: no cover
    zstandard = None

__all__ = ["Checkpointer", "latest_step", "save", "restore"]

_FORMAT_VERSION = 2
MANIFEST = "manifest.json"
CODECS = ("zstd", "zlib", "raw")
_WORKERS = min(8, os.cpu_count() or 1)  # threads hashing and (de)compressing leaves


class _Codec:
    """zstd when available, zlib otherwise; recorded in the manifest so a
    checkpoint restores whichever environment wrote it."""

    @staticmethod
    def default() -> str:
        return "zstd" if zstandard is not None else "zlib"

    @staticmethod
    def compress(raw: bytes, codec: str) -> bytes:
        if codec == "raw":
            return raw
        if codec == "zstd":
            if zstandard is None:
                raise ImportError("checkpoint written with zstd but zstandard not installed")
            return zstandard.ZstdCompressor(level=3).compress(raw)
        import zlib

        return zlib.compress(raw, 3)

    @staticmethod
    def decompress(blob: bytes, codec: str) -> bytes:
        if codec == "raw":
            return blob
        if codec == "zstd":
            if zstandard is None:
                raise ImportError("checkpoint written with zstd but zstandard not installed")
            return zstandard.ZstdDecompressor().decompress(blob)
        import zlib

        return zlib.decompress(blob)


def _children(node) -> Optional[dict]:
    """The named children of an inner node (a mapping or a dataclass), else None."""
    if isinstance(node, Mapping):
        return dict(node)
    if dataclasses.is_dataclass(node) and not isinstance(node, type):
        return {f.name: getattr(node, f.name) for f in dataclasses.fields(node)}
    return None


def _flatten(tree, prefix: str = ""):
    """(path, leaf) pairs in sorted key order (a NamedSharding is a leaf)."""
    kids = None if isinstance(tree, NamedSharding) else _children(tree)
    if kids is None:
        yield prefix, tree
        return
    for k in sorted(kids):
        yield from _flatten(kids[k], f"{prefix}/{k}" if prefix else str(k))


def _rebuild(template, leaves: dict, prefix: str = ""):
    kids = _children(template)
    if kids is None:
        return leaves[prefix]
    out = {k: _rebuild(v, leaves, f"{prefix}/{k}" if prefix else str(k)) for k, v in kids.items()}
    return out if isinstance(template, Mapping) else type(template)(**out)


def _to_host(leaf) -> tuple:
    """(numpy array, dtype name) of one leaf, copied to host memory."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16).copy(), "bfloat16"
        arr = t.numpy().copy()
    else:
        arr = np.array(leaf)
    return arr, str(arr.dtype)


def _from_raw(raw: bytes, meta: dict, template):
    shape = tuple(meta["shape"])
    if meta["dtype"] == "bfloat16":
        t = torch.from_numpy(np.frombuffer(raw, dtype=np.uint16).reshape(shape).copy()).view(torch.bfloat16)
    else:
        arr = np.frombuffer(raw, dtype=np.dtype(meta["dtype"])).reshape(shape).copy()
        if not isinstance(template, torch.Tensor):
            return arr
        t = torch.from_numpy(arr)
    if not isinstance(template, torch.Tensor):
        return t
    if tuple(template.shape) == shape and template.dtype == t.dtype:
        out = torch.empty_strided(template.shape, template.stride(), dtype=t.dtype, device=template.device)
        return out.copy_(t)
    return t.to(template.device)


def _snapshot(state) -> tuple:
    """(host arrays, dtype names, paths): the state copied off the device."""
    flat = list(_flatten(state))
    host = [_to_host(leaf) for _, leaf in flat]
    return [a for a, _ in host], [d for _, d in host], [p for p, _ in flat]


def save(state: Any, directory: str, step: int, *, extra: Optional[dict] = None, codec: Optional[str] = None,
         shardings: Any = None):
    """Blocking atomic save of a nested state (``codec``: one of
    :data:`CODECS`, default zstd where it imports, else zlib).

    ``shardings``: a tree parallel to ``state`` of each leaf's
    ``NamedSharding`` on the live mesh the ranks hold their blocks on; every
    rank calls this, rank 0 gathers the blocks (through the host) and
    writes the whole leaves, and all return once the checkpoint is in place."""
    if shardings is None:
        _write(*_snapshot(state), directory, step, extra or {}, codec or _Codec.default())
        return
    whole = {}
    sh_of = dict(_flatten(shardings))
    for path, leaf in _flatten(state):
        sh = sh_of[path]
        blocks = gather_to_first(leaf, sh.mesh)
        if blocks is not None:
            whole[path] = assemble(blocks, sh.spec, sh.mesh)
    if whole:
        _write(*_snapshot(_rebuild(state, whole)), directory, step, extra or {}, codec or _Codec.default())
    torch.distributed.barrier()


def _write_leaf(tmp: str, fname: str, arr: np.ndarray, codec: str) -> str:
    """Write one leaf's compressed bytes; returns the sha of its raw bytes."""
    raw = arr.tobytes()
    with open(os.path.join(tmp, fname), "wb") as f:
        f.write(_Codec.compress(raw, codec))
    return hashlib.sha256(raw).hexdigest()[:16]


def _write(host_leaves, dtypes, paths, directory, step, extra, codec):
    if codec not in CODECS:
        raise ValueError(f"codec {codec!r} not in {CODECS}")
    os.makedirs(directory, exist_ok=True)
    tmp = os.path.join(directory, f"step_{step}.tmp")
    final = os.path.join(directory, f"step_{step}")
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {
        # as the reference's: zstd manifests at version 2, zlib (and raw) at 3
        "version": _FORMAT_VERSION if codec == "zstd" else _FORMAT_VERSION + 1,
        "step": step,
        "extra": extra,
        "codec": codec,
        "leaves": [],
    }
    fnames = [f"leaf_{i:05d}.npy.zst" for i in range(len(paths))]  # the reference's names, whatever the codec
    with ThreadPoolExecutor(_WORKERS) as pool:
        shas = list(pool.map(lambda fa: _write_leaf(tmp, fa[0], fa[1], codec), zip(fnames, host_leaves)))
    for arr, dtype, path, fname, sha in zip(host_leaves, dtypes, paths, fnames, shas):
        manifest["leaves"].append({"path": path, "file": fname, "shape": list(arr.shape), "dtype": dtype,
                                   "sha": sha})
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    for d in os.listdir(directory):  # prune interrupted saves
        if d.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def _steps(directory: str) -> list:
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("step_") and not d.endswith(".tmp"))


def latest_step(directory: str) -> Optional[int]:
    """The newest complete checkpoint's step (a manifest present), or None."""
    if not os.path.isdir(directory):
        return None
    steps = [s for s in _steps(directory) if os.path.exists(os.path.join(directory, f"step_{s}", MANIFEST))]
    return max(steps) if steps else None


def restore(template: Any, directory: str, *, step: Optional[int] = None, validate: bool = True,
            shardings: Any = None):
    """Restore into the structure of ``template``; returns (state, manifest).
    ``step`` defaults to the latest.  Raises IOError on a checksum mismatch.
    ``shardings``: a tree of ``NamedSharding`` parallel to ``template``, on
    any mesh; each leaf then comes back as this rank's block of it, on the
    template leaf's device."""
    step = latest_step(directory) if step is None else step
    if step is None:
        raise FileNotFoundError(f"no checkpoint found in {directory}")
    d = os.path.join(directory, f"step_{step}")
    with open(os.path.join(d, MANIFEST)) as f:
        manifest = json.load(f)
    version = manifest.get("version", 1)
    if version not in (2, 3):
        raise ValueError(f"checkpoint format version {version} not supported by this reader (known: 2-3)")
    flat = list(_flatten(template))
    if len(flat) != len(manifest["leaves"]):
        raise ValueError(f"checkpoint has {len(manifest['leaves'])} leaves, template has {len(flat)}")
    by_path = {m["path"]: m for m in manifest["leaves"]}

    def read(meta) -> bytes:
        with open(os.path.join(d, meta["file"]), "rb") as f:
            raw = _Codec.decompress(f.read(), manifest["codec"])
        if validate and hashlib.sha256(raw).hexdigest()[:16] != meta["sha"]:
            raise IOError(f"checksum mismatch for {meta['path']}")
        return raw

    metas = [by_path[path] for path, _ in flat]
    with ThreadPoolExecutor(_WORKERS) as pool:
        raws = list(pool.map(read, metas))
    if shardings is not None:
        sh = dict(_flatten(shardings))
        leaves = {path: ElasticReshard(getattr(leaf, "device", None)).apply(_from_raw(raw, meta, None), sh[path])
                  for (path, leaf), raw, meta in zip(flat, raws, metas)}
    else:
        leaves = {path: _from_raw(raw, meta, leaf) for (path, leaf), raw, meta in zip(flat, raws, metas)}
    return _rebuild(template, leaves), manifest


@dataclasses.dataclass
class Checkpointer:
    """Async checkpoint manager with retention: the ``keep`` newest stay.
    ``codec``: as :func:`save`'s."""

    directory: str
    keep: int = 3
    codec: Optional[str] = None

    def __post_init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def save_async(self, state: Any, step: int, *, extra: Optional[dict] = None):
        self.wait()  # one outstanding save at a time
        snap = _snapshot(state)  # on the host before the writer starts

        def work():
            try:
                _write(*snap, self.directory, step, extra or {}, self.codec or _Codec.default())
                self._prune()
            except BaseException as e:  # re-raised by the next wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def _prune(self):
        for s in _steps(self.directory)[: -self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s}"), ignore_errors=True)

    def restore_latest(self, template):
        return restore(template, self.directory)
