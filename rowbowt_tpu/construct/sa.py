"""Suffix array construction.

Host-side, like the reference's (pfbwt-f runs as a separate process before
rb_build, /root/reference/scripts/vcf_to_rowbowt.sh).  Two backends:

- native: SA-IS implemented in C++ (native/sais.cpp), loaded via ctypes — O(n),
  used automatically when the shared library has been built (`make -C native`).
- numpy fallback: prefix-doubling with lexsort, O(n log^2 n) — fine for tests
  and small panels.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_NATIVE = None


def _load_native():
    """The native library, or None while it is not built (looked up again
    on the next call, so a build made after import is picked up)."""
    global _NATIVE
    if _NATIVE is not None:
        return _NATIVE
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    for cand in (
        os.path.join(here, "native", "librbt_native.so"),
        os.path.join(os.path.dirname(__file__), "librbt_native.so"),
    ):
        if os.path.exists(cand):
            lib = ctypes.CDLL(cand)
            lib.rbt_sais_u8.argtypes = [
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64,
            ]
            lib.rbt_sais_u8.restype = ctypes.c_int
            _NATIVE = lib
            break
    return _NATIVE


def suffix_array_numpy(text: np.ndarray) -> np.ndarray:
    """Prefix-doubling suffix array over uint8 text (no implicit sentinel:
    suffixes compare as plain byte strings; the caller's final TERM byte is the
    unique smallest byte so ordering matches the standard convention)."""
    n = int(text.shape[0])
    if n == 0:
        return np.empty(0, dtype=np.int64)
    rank = text.astype(np.int64)
    k = 1
    idx = np.arange(n, dtype=np.int64)
    while True:
        rank2 = np.full(n, -1, dtype=np.int64)
        rank2[: n - k] = rank[k:]
        order = np.lexsort((rank2, rank))
        new_rank = np.empty(n, dtype=np.int64)
        key_prev = (rank[order[:-1]], rank2[order[:-1]])
        key_next = (rank[order[1:]], rank2[order[1:]])
        neq = (key_prev[0] != key_next[0]) | (key_prev[1] != key_next[1])
        new_rank[order] = np.concatenate(([0], np.cumsum(neq)))
        rank = new_rank
        if rank[order[-1]] == n - 1:
            return order.astype(np.int64)
        k *= 2
        idx = order


def suffix_array(text: np.ndarray) -> np.ndarray:
    """Suffix array of uint8 text; native SA-IS when available."""
    text = np.ascontiguousarray(text, dtype=np.uint8)
    lib = _load_native()
    if lib is not None and text.shape[0] > 0:
        n = int(text.shape[0])
        sa = np.empty(n, dtype=np.int64)
        rc = lib.rbt_sais_u8(
            text.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            sa.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            n,
        )
        if rc == 0:
            return sa
    return suffix_array_numpy(text)
