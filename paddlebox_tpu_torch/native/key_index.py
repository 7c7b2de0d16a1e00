"""KeyIndex, block_plan and dedup_plan — the port of
``native/key_index.py``.

The native backend is the port's own copy of ``key_index.cc`` (same
directory), built with g++ at first use into ``_build/``. When no
compiler is available the NumPy/dict paths below run instead; both
backends give identical results (ids in first-occurrence order, the same
counting-sort plans).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import threading

import numpy as np

from paddlebox_tpu_torch.native import build as build_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "key_index.cc")
_lock = threading.Lock()
_lib_cache: list = []


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    u64p = np.ctypeslib.ndpointer(np.uint64, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    lib.ki_create.restype = c.c_void_p
    lib.ki_create.argtypes = [c.c_int64]
    lib.ki_free.restype = None
    lib.ki_free.argtypes = [c.c_void_p]
    lib.ki_size.restype = c.c_int64
    lib.ki_size.argtypes = [c.c_void_p]
    lib.ki_lookup.restype = None
    lib.ki_lookup.argtypes = [c.c_void_p, u64p, c.c_int64, i64p]
    lib.ki_lookup_or_insert.restype = c.c_int64
    lib.ki_lookup_or_insert.argtypes = [c.c_void_p, u64p, c.c_int64, i64p]
    lib.ki_rebuild.restype = None
    lib.ki_rebuild.argtypes = [c.c_void_p, u64p, c.c_int64]
    lib.pbtpu_block_plan.restype = None
    lib.pbtpu_block_plan.argtypes = [i32p, c.c_int64, c.c_int32, c.c_int64,
                                     i32p, i32p, i32p]
    lib.pbtpu_dedup_plan.restype = c.c_int64
    lib.pbtpu_dedup_plan.argtypes = [i32p, c.c_int64, c.c_int64, c.c_int32,
                                     c.c_int64, i32p, i32p, i32p, i32p,
                                     i32p]


def get_lib() -> ctypes.CDLL | None:
    """The native key-index library, built on first use; None when no C++
    compiler is available (callers take their NumPy paths)."""
    with _lock:
        if _lib_cache:
            return _lib_cache[0]
        lib = None
        cxx = os.environ.get("CXX") or shutil.which("g++")
        if cxx is not None:
            cmd = [cxx, "-O3", "-std=c++17", "-fPIC", "-shared", "-pthread"]
            try:
                path = build_lib.build("libkeyindex", [_SRC], [], cmd)
                lib = ctypes.CDLL(path)
                _configure(lib)
            except (build_lib.BuildError, OSError) as e:
                import warnings
                warnings.warn(f"native key index unavailable ({e}); "
                              f"using the NumPy paths")
                lib = None
        _lib_cache.append(lib)
        return lib


def block_plan(idx: np.ndarray, super_block: int, n_blocks: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Group token row-ids by table super-block (the host half of the
    binned push).

    Returns (order (n,), rstart (n_blocks,), end (n_blocks,)) int32:
    block b's tokens are ``order[first_b:end[b]]``, and ``rstart[b]`` is
    ``first_b`` rounded down to a multiple of 8, so a window may begin
    with up to 7 tokens of earlier blocks. Ids outside the blocks clip
    into the first or last block (the kernel's row-range check drops
    them). A stable counting sort, so within a block tokens keep their
    batch order."""
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    n = len(idx)
    if n_blocks < 1 or super_block < 1:
        raise ValueError("block_plan needs n_blocks >= 1, super_block >= 1")
    lib = get_lib()
    if lib is not None:
        order = np.empty(n, np.int32)
        rstart = np.empty(n_blocks, np.int32)
        end = np.empty(n_blocks, np.int32)
        lib.pbtpu_block_plan(idx, n, super_block, n_blocks, order, rstart,
                             end)
        return order, rstart, end
    # the native sort divides truncating toward zero: negative ids land
    # in block 0 there and here
    bk = np.clip(idx // super_block, 0, n_blocks - 1)
    order = np.argsort(bk, kind="stable").astype(np.int32)
    counts = np.bincount(bk, minlength=n_blocks)
    ends = np.cumsum(counts)
    starts = ends - counts
    return (order, ((starts // 8) * 8).astype(np.int32),
            ends.astype(np.int32))


def dedup_plan(idx: np.ndarray, n_rows: int, super_block: int,
               n_blocks: int) -> tuple[np.ndarray, ...]:
    """Full-row counting sort + unique-row segment bounds (the host half
    of the dedup pre-merge).

    Returns (order (n,), uniq (n,), segend (n,), rstart (n_blocks,),
    end (n_blocks,)) int32. ``uniq`` pads with ascending out-of-range ids
    and ``segend`` pads with zero-width segments, so the device pre-merge
    needs no dynamic shapes.
    """
    idx = np.ascontiguousarray(idx, dtype=np.int32)
    n = len(idx)
    if n_blocks < 1 or super_block < 1:
        raise ValueError("dedup_plan needs n_blocks >= 1, super_block >= 1")
    lib = get_lib()
    if lib is not None:
        order = np.empty(n, np.int32)
        uniq = np.empty(n, np.int32)
        segend = np.empty(n, np.int32)
        rstart = np.empty(n_blocks, np.int32)
        end = np.empty(n_blocks, np.int32)
        lib.pbtpu_dedup_plan(idx, n, n_rows, super_block, n_blocks,
                             order, uniq, segend, rstart, end)
        return order, uniq, segend, rstart, end
    r = np.where((idx < 0) | (idx >= n_rows), n_rows, idx)
    order = np.argsort(r, kind="stable").astype(np.int32)
    sr = r[order]
    n_valid = int(np.searchsorted(sr, n_rows))
    uniq_rows, first = np.unique(sr[:n_valid], return_index=True)
    u = len(uniq_rows)
    uniq = np.empty(n, np.int32)
    uniq[:u] = uniq_rows
    uniq[u:] = n_rows + np.arange(n - u, dtype=np.int32)
    segend = np.full(n, n_valid, np.int32)
    segend[:max(0, u - 1)] = first[1:]
    b = np.minimum(uniq_rows // super_block, n_blocks - 1)
    counts = np.bincount(b, minlength=n_blocks)
    ends = np.cumsum(counts)
    return (order, uniq, segend,
            (((ends - counts) // 8) * 8).astype(np.int32),
            ends.astype(np.int32))


class KeyIndex:
    """Batch uint64 → int64 key index; native backend when available.

    force_python=True pins the dict backend."""

    def __init__(self, capacity_hint: int = 1024,
                 force_python: bool = False):
        self._lib = None if force_python else get_lib()
        if self._lib is not None:
            self._h = self._lib.ki_create(int(capacity_hint))
            if not self._h:
                self._lib = None
        if self._lib is None:
            self._d: dict[int, int] = {}

    @property
    def is_native(self) -> bool:
        return self._lib is not None

    def __del__(self):
        lib = getattr(self, "_lib", None)
        if lib is not None and getattr(self, "_h", None):
            lib.ki_free(self._h)
            self._h = None

    def __len__(self) -> int:
        if self._lib is not None:
            return int(self._lib.ki_size(self._h))
        return len(self._d)

    def lookup(self, keys: np.ndarray) -> np.ndarray:
        """→ int64 ids, -1 for absent keys."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty(len(keys), dtype=np.int64)
        if self._lib is not None:
            self._lib.ki_lookup(self._h, keys, len(keys), out)
        else:
            d = self._d
            for i, k in enumerate(keys.tolist()):
                out[i] = d.get(k, -1)
        return out

    def lookup_or_insert(self, keys: np.ndarray) -> tuple[np.ndarray, int]:
        """→ (int64 ids, n_new); new keys get sequential ids from len(self)
        in first-occurrence order."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        out = np.empty(len(keys), dtype=np.int64)
        if self._lib is not None:
            added = int(self._lib.ki_lookup_or_insert(
                self._h, keys, len(keys), out))
            return out, added
        d = self._d
        added = 0
        for i, k in enumerate(keys.tolist()):
            j = d.get(k, -1)
            if j < 0:
                j = len(d)
                d[k] = j
                added += 1
            out[i] = j
        return out, added

    def rebuild(self, keys: np.ndarray) -> None:
        """Reset to exactly ``keys`` with ids 0..n-1."""
        keys = np.ascontiguousarray(keys, dtype=np.uint64)
        if self._lib is not None:
            self._lib.ki_rebuild(self._h, keys, len(keys))
        else:
            self._d = {int(k): i for i, k in enumerate(keys.tolist())}
