"""Stable 64-bit hashing — the port's copy of ``utils/hashing.py``.

``hash64`` is FNV-1a 64 (instance ids; the native parser computes the
same hash in C++) and ``hash64_array`` a vectorized splitmix64 over
feature signs. Both are identical across hosts and processes (Python's
``hash()`` is salted per process) and bit-identical to the JAX
package's.
"""

from __future__ import annotations

import numpy as np

_FNV_OFFSET = 0xCBF29CE484222325
_FNV_PRIME = 0x100000001B3
_MASK = 0xFFFFFFFFFFFFFFFF


def hash64(s: str | bytes) -> int:
    if isinstance(s, str):
        s = s.encode("utf-8")
    h = _FNV_OFFSET
    for b in s:
        h ^= b
        h = (h * _FNV_PRIME) & _MASK
    return h


def hash64_array(a: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 over a uint64/int64 array."""
    x = a.astype(np.uint64, copy=True)
    m = np.uint64(_MASK)
    with np.errstate(over="ignore"):
        x = (x + np.uint64(0x9E3779B97F4A7C15)) & m
        z = x
        z = ((z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)) & m
        z = ((z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)) & m
        z = z ^ (z >> np.uint64(31))
    return z
