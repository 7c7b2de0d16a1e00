"""ctypes binding for the native MultiSlot parser — the port of
``native/slot_parser_binding.py``.

The library is the port's own copy of ``slot_parser.cc`` (same
directory), built with g++ at first use into ``_build/`` with the key
index's flags (:func:`native.build.cxx_command`). ``parse_lines`` and
``parse_buffer`` give the same columnar output as the Python parser in
``data/parser.py`` and the same contract as the JAX package's binding:
they return None when the library is unavailable and raise ValueError
on the first malformed line (the native parser is strict; the caller
re-parses in Python, which skips and names each bad line).

:func:`available` says whether the library loaded and
:func:`build_error` why it did not: a caller that must parse natively
(the card path in ``chip_smoke.py``) checks them instead of relying on
the Python parser quietly standing in.
"""

from __future__ import annotations

import ctypes
import os
import threading
import warnings
from typing import Iterable

import numpy as np

from paddlebox_tpu_torch.native import build as build_lib

_SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "slot_parser.cc")
_lock = threading.Lock()
_lib_cache: list = []          # [lib or None] once the first load ran
_error_cache: list = []        # [why the load failed, or None]


def _configure(lib: ctypes.CDLL) -> None:
    c = ctypes
    lib.sp_parse.restype = c.c_void_p
    lib.sp_parse.argtypes = [
        c.c_char_p, c.c_int64, c.c_int32,
        c.POINTER(c.c_int32), c.POINTER(c.c_int32), c.POINTER(c.c_int32),
        c.c_int32, c.c_int32, c.c_char_p, c.c_int64]
    lib.sp_num_examples.restype = c.c_int64
    lib.sp_num_examples.argtypes = [c.c_void_p]
    lib.sp_sparse_nnz.restype = c.c_int64
    lib.sp_sparse_nnz.argtypes = [c.c_void_p, c.c_int32]
    lib.sp_copy_sparse_values.restype = None
    lib.sp_copy_sparse_values.argtypes = [c.c_void_p, c.c_int32, c.c_void_p]
    lib.sp_copy_sparse_offsets.restype = None
    lib.sp_copy_sparse_offsets.argtypes = [c.c_void_p, c.c_int32, c.c_void_p]
    lib.sp_copy_floats.restype = None
    lib.sp_copy_floats.argtypes = [c.c_void_p, c.c_int32, c.c_void_p]
    lib.sp_copy_ins_ids.restype = None
    lib.sp_copy_ins_ids.argtypes = [c.c_void_p, c.c_void_p]
    lib.sp_free.restype = None
    lib.sp_free.argtypes = [c.c_void_p]
    lib.sp_hash64.restype = c.c_uint64
    lib.sp_hash64.argtypes = [c.c_char_p, c.c_int64]


def get_lib() -> ctypes.CDLL | None:
    """The native parser library, built on first use; None when no C++
    compiler is available or the build fails (with a warning naming
    why; :func:`build_error` keeps the reason)."""
    with _lock:
        if _lib_cache:
            return _lib_cache[0]
        lib, err = None, None
        cmd = build_lib.cxx_command()
        if cmd is None:
            err = "no C++ compiler: neither $CXX nor g++ was found"
        else:
            try:
                lib = ctypes.CDLL(build_lib.build("libslotparser", [_SRC],
                                                  [], cmd))
                _configure(lib)
            except (build_lib.BuildError, OSError) as e:
                lib, err = None, str(e)
        if lib is None:
            warnings.warn(f"native slot parser unavailable ({err}); "
                          f"MultiSlot text parses in Python")
        _lib_cache.append(lib)
        _error_cache.append(err)
        return lib


def available() -> bool:
    """Whether the native parser loaded (parses go through C++)."""
    return get_lib() is not None


def build_error() -> str | None:
    """Why the native parser is unavailable; None when it loaded."""
    get_lib()
    return _error_cache[0]


def parse_buffer(buf: bytes, schema, with_ins_id: bool = False,
                 n_threads: int = 0):
    """Parse a raw MultiSlot text buffer into a SlotRecordBatch.

    ``n_threads`` parser threads split the buffer at line boundaries (0:
    one per hardware thread); the result does not depend on it. Raises
    ValueError on malformed input; returns None when the native library
    is unavailable."""
    from paddlebox_tpu_torch.data.schema import SlotType
    from paddlebox_tpu_torch.data.slot_record import SlotRecordBatch

    lib = get_lib()
    if lib is None:
        return None
    slots = schema.slots
    n = len(slots)
    types = (ctypes.c_int32 * n)(
        *[0 if s.type == SlotType.UINT64 else 1 for s in slots])
    used = (ctypes.c_int32 * n)(*[1 if s.is_used else 0 for s in slots])
    widths = (ctypes.c_int32 * n)(*[s.max_len for s in slots])
    errbuf = ctypes.create_string_buffer(512)
    res = lib.sp_parse(buf, len(buf), n, types, used, widths,
                       1 if with_ins_id else 0, int(n_threads), errbuf,
                       len(errbuf))
    if not res:
        raise ValueError(errbuf.value.decode("utf-8", "replace"))
    try:
        num = lib.sp_num_examples(res)
        sparse_values, sparse_offsets = [], []
        for s in range(len(schema.sparse_slots)):
            nnz = lib.sp_sparse_nnz(res, s)
            vals = np.empty(nnz, dtype=np.int64)
            offs = np.zeros(num + 1, dtype=np.int64)
            if nnz:
                lib.sp_copy_sparse_values(
                    res, s, vals.ctypes.data_as(ctypes.c_void_p))
            lib.sp_copy_sparse_offsets(
                res, s, offs.ctypes.data_as(ctypes.c_void_p))
            sparse_values.append(vals)
            sparse_offsets.append(offs)
        float_values = []
        for f, slot in enumerate(schema.float_slots):
            fv = np.empty(num * slot.max_len, dtype=np.float32)
            if len(fv):
                lib.sp_copy_floats(res, f,
                                   fv.ctypes.data_as(ctypes.c_void_p))
            float_values.append(fv)
        ins = np.zeros(num, dtype=np.uint64)
        if with_ins_id and num:
            lib.sp_copy_ins_ids(res, ins.ctypes.data_as(ctypes.c_void_p))
        return SlotRecordBatch(
            schema=schema, num=int(num),
            sparse_values=sparse_values, sparse_offsets=sparse_offsets,
            float_values=float_values, ins_id=ins,
            search_id=np.zeros(num, dtype=np.uint64),
            rank=np.zeros(num, dtype=np.int32),
            cmatch=np.zeros(num, dtype=np.int32),
        )
    finally:
        lib.sp_free(res)


def parse_lines(lines: Iterable[str], schema, with_ins_id: bool = False):
    """``parse_buffer`` over text lines; None (``lines`` untouched) when
    the library is unavailable."""
    if get_lib() is None:
        # bail before touching `lines`: consuming a one-shot iterator
        # here would hand the Python parser an exhausted generator
        return None
    buf = "\n".join(lines).encode("utf-8")
    return parse_buffer(buf, schema, with_ins_id=with_ins_id)


def hash64_native(s: str | bytes) -> int:
    """FNV-1a 64 of ``s`` in C++ (``utils.hashing.hash64``'s twin)."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native slot parser unavailable: "
                           f"{build_error()}")
    if isinstance(s, str):
        s = s.encode("utf-8")
    return int(lib.sp_hash64(s, len(s)))
