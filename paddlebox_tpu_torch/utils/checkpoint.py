"""Atomic writes, manifests and the dense tree ↔ npz format — the port of
``paddlebox_tpu/utils/checkpoint.py``.

Copied as they are: ``CheckpointCorruptError`` (:39), ``atomic_file``
(:54, tmp → fsync → ``os.replace`` → directory fsync), ``crc32_file``
(:103), ``file_entry`` (:121) and the manifest trio
``write_manifest`` / ``read_manifest`` / ``verify_manifest``
(:130-193), with the checksum's ``ckpt.crc_seconds`` / ``ckpt.crc_files``
counters.

``save_tree`` / ``load_tree`` replace the reference's jax pytree
``save_pytree`` / ``load_pytree`` (:209/:234) over nested dicts, lists
and tuples of numpy arrays or tensors. Each leaf is one npz member named
by its path, as the reference's ``_path_str`` (:195) names it: dict keys
in sorted order, sequence indices, joined by ``/`` —
``params/mlp/0/w``, ``opt_state/0/mu/mlp/0/w``, ``opt_state/0/count``,
``auc/pos``. A file written by either package loads in the other.
"""

from __future__ import annotations

import json
import os
import zipfile
import zlib
from contextlib import contextmanager
from typing import Any

import numpy as np

from paddlebox_tpu_torch.utils import faultpoint

MANIFEST_NAME = "MANIFEST.json"


class CheckpointCorruptError(RuntimeError):
    """A checkpoint member is truncated/corrupt (bad zip, bad CRC, bad
    size, missing file). Carries the offending path in ``fname``."""

    def __init__(self, fname: str, detail: str):
        super().__init__(f"checkpoint {fname!r} is corrupt or truncated: "
                         f"{detail}")
        self.fname = fname


# ---------------------------------------------------------------------------
# atomic durable writes
# ---------------------------------------------------------------------------

@contextmanager
def atomic_file(path: str, fault_point: str | None = None):
    """Yield a temp path in ``path``'s directory; on clean exit fsync it and
    ``os.replace`` onto ``path`` (then fsync the directory so the rename
    itself is durable). On exception the temp file is removed and ``path``
    is untouched — a crashed writer never leaves a partial file under the
    final name.

    ``fault_point``: optional faultpoint name hit between the durable tmp
    write and the rename — the window the atomicity claim is about.
    """
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        yield tmp
        with open(tmp, "rb+") as f:
            f.flush()
            os.fsync(f.fileno())
        if fault_point is not None:
            faultpoint.hit(fault_point)
        os.replace(tmp, path)
        _fsync_dir(d)
    except BaseException:
        try:
            os.unlink(tmp)
        # pblint: disable=silent-except -- unwind-path hygiene: the
        # original exception is re-raised below and must not be masked
        # by a failed tmp cleanup (worst case: an orphan .tmp file)
        except OSError:
            pass
        raise


def _fsync_dir(d: str) -> None:
    try:
        fd = os.open(d, os.O_RDONLY)
    except OSError:          # platform without directory fds
        return
    try:
        os.fsync(fd)
    # pblint: disable=silent-except -- directory fsync is best-effort
    # durability hardening: some filesystems reject fsync on directory
    # fds; the file's own fsync already committed its bytes
    except OSError:
        pass
    finally:
        os.close(fd)


def crc32_file(path: str, chunk: int = 1 << 20) -> int:
    import time

    from paddlebox_tpu_torch.monitor import counter_add
    t0 = time.perf_counter()
    crc = 0
    with open(path, "rb") as f:
        while True:
            b = f.read(chunk)
            if not b:
                # the checksum's cost is part of the checkpoint budget the
                # flight record accounts (save and verify both land here)
                counter_add("ckpt.crc_seconds", time.perf_counter() - t0)
                counter_add("ckpt.crc_files")
                return crc & 0xFFFFFFFF
            crc = zlib.crc32(b, crc)


def file_entry(path: str) -> dict[str, int]:
    """Manifest entry for one on-disk member: {bytes, crc32}."""
    return {"bytes": os.path.getsize(path), "crc32": crc32_file(path)}


# ---------------------------------------------------------------------------
# manifests
# ---------------------------------------------------------------------------

def write_manifest(dirpath: str, files: dict[str, dict],
                   fault_point: str | None = None, **meta: Any) -> str:
    """Atomically commit ``MANIFEST.json`` for a snapshot directory.

    ``files`` maps member-relative-path → ``file_entry`` dict. Extra
    keyword metadata (pass_id, save_seq, chain parent, …) is stored
    alongside. The manifest lands LAST, atomically — its presence is the
    snapshot's commit record; a snapshot without one never existed.
    """
    out = os.path.join(dirpath, MANIFEST_NAME)
    doc = dict(meta)
    doc["files"] = files
    with atomic_file(out, fault_point=fault_point) as tmp:
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
    return out


def read_manifest(dirpath: str) -> dict | None:
    p = os.path.join(dirpath, MANIFEST_NAME)
    if not os.path.exists(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (json.JSONDecodeError, OSError) as e:
        raise CheckpointCorruptError(p, f"unreadable manifest ({e})")


def verify_manifest(dirpath: str, manifest: dict | None = None,
                    only: list[str] | None = None) -> dict:
    """Re-hash the members listed in ``dirpath``'s manifest; raise
    :class:`CheckpointCorruptError` on the first missing/short/mismatched
    member, naming it. Returns the (parsed) manifest. ``only`` restricts
    verification to a subset of members (e.g. the delta chain prefix a
    resume actually replays)."""
    m = manifest if manifest is not None else read_manifest(dirpath)
    if m is None:
        raise CheckpointCorruptError(
            os.path.join(dirpath, MANIFEST_NAME),
            "missing manifest (snapshot was never committed)")
    names = only if only is not None else list(m.get("files", {}))
    for name in names:
        ent = m["files"].get(name)
        p = os.path.join(dirpath, name)
        if ent is None:
            raise CheckpointCorruptError(p, "member absent from manifest")
        if not os.path.exists(p):
            raise CheckpointCorruptError(p, "member file missing on disk")
        size = os.path.getsize(p)
        if size != ent["bytes"]:
            raise CheckpointCorruptError(
                p, f"size {size} != manifest {ent['bytes']} "
                   f"(truncated or torn write)")
        crc = crc32_file(p)
        if crc != ent["crc32"]:
            raise CheckpointCorruptError(
                p, f"crc32 {crc:#010x} != manifest {ent['crc32']:#010x}")
    return m


# ---------------------------------------------------------------------------
# dense tree ↔ npz
# ---------------------------------------------------------------------------

def flatten_tree(tree: Any, prefix: str = "") -> list[tuple[str, Any]]:
    """[(path, leaf)] in the reference's flatten order: dict keys sorted,
    list/tuple items by index; an empty dict, list or tuple (optax's
    ``EmptyState``) has no leaves."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, (list, tuple)):
        items = [(str(i), v) for i, v in enumerate(tree)]
    else:
        return [(prefix, tree)]
    out = []
    for k, v in items:
        out += flatten_tree(v, f"{prefix}/{k}" if prefix else k)
    return out


def _unflatten(template: Any, leaves) -> Any:
    """``template``'s structure with its leaves taken in order from the
    ``leaves`` iterator."""
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_unflatten(v, leaves) for v in template)
    return next(leaves)


def _host(leaf) -> np.ndarray:
    if hasattr(leaf, "detach"):                    # a torch tensor
        leaf = leaf.detach().cpu().numpy()
    # order="C", not ascontiguousarray: the latter promotes 0-d leaves
    # like adam's count to (1,), which fails the shape check on load
    return np.asarray(leaf, order="C")


def save_tree(tree: Any, fname: str, compress: bool = True) -> str:
    """Write every leaf of ``tree`` as one npz member named by its path,
    C order, shape and dtype kept. Atomic-durable (``atomic_file``): a
    reader sees the previous complete file or the new one, never a
    truncation under the final name."""
    arrays = {path: _host(leaf) for path, leaf in flatten_tree(tree)}
    with atomic_file(fname, fault_point="ckpt.dense.pre_replace") as tmp:
        # write through an open handle: np.savez would append ".npz" to a
        # bare path, breaking the tmp → final rename pairing
        with open(tmp, "wb") as f:
            (np.savez_compressed if compress else np.savez)(f, **arrays)
    return fname


def load_tree(template: Any, fname: str) -> Any:
    """Load into the structure of ``template`` as numpy arrays (shapes must
    match; dtypes are the file's). A truncated or corrupt archive raises
    :class:`CheckpointCorruptError` naming the file — the resume path keys
    its fallback on that; a missing leaf raises KeyError."""
    try:
        ctx = np.load(fname)
    except (zipfile.BadZipFile, EOFError, ValueError) as e:
        raise CheckpointCorruptError(fname, str(e))
    except OSError as e:
        if not os.path.exists(fname):
            raise
        raise CheckpointCorruptError(fname, str(e))
    out = []
    with ctx as z:
        for key, leaf in flatten_tree(template):
            if key not in z:
                raise KeyError(f"checkpoint {fname} missing leaf {key!r}")
            try:
                arr = z[key]
            except (zipfile.BadZipFile, EOFError, zlib.error,
                    ValueError) as e:
                raise CheckpointCorruptError(
                    fname, f"member {key!r} unreadable ({e})")
            want = tuple(leaf.shape) if hasattr(leaf, "shape") \
                else np.shape(leaf)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"leaf {key!r}: checkpoint shape {arr.shape} != {want}")
            out.append(arr)
    return _unflatten(template, iter(out))
