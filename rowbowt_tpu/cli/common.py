"""Shared CLI plumbing: index loading, shape-bucketed batching, timers.

The reference binaries stream one read at a time (rb_align.cpp:176-178) or
through a thread pool (rb_markers.cpp:318-535); the device pipeline instead
gathers reads into fixed-shape batches (padded lengths bucketed to powers of
two so jit caches stay warm) and keeps OUTPUT IN INPUT ORDER — strictly
stronger than rb_markers' nondeterministic thread interleaving, and identical
to rb_align's ordering.
"""

from __future__ import annotations

import sys
import time

import numpy as np

from rowbowt_tpu.engine.batch import encode_batch
from rowbowt_tpu.index import RbtIndex
from rowbowt_tpu.io.fastq import batched, read_seqs


def eprint(*a):
    print(*a, file=sys.stderr)


def pow2_at_least(x: int, floor: int = 32) -> int:
    p = floor
    while p < x:
        p <<= 1
    return p


class Timer:
    def __init__(self):
        self.t0 = time.perf_counter()

    def lap(self) -> float:
        return time.perf_counter() - self.t0


def load_index(prefix: str, sa=False, ma=False, dl=False, ft=False):
    """Flag-gated index load (LoadRbwtFlag role, rowbowt_io.hpp:146-189).

    Auto-detects the two-level big (n >= 2^31) artifact — one CLI serves any
    index, like the reference's binaries (rb_align.cpp:147-193).  Big
    artifacts defer flag gating to device_index (host load is mmap'd)."""
    from rowbowt_tpu.bigindex import BigIndex

    if BigIndex.is_big_dir(prefix):
        eprint(f"loading (big two-level artifact): {prefix}")
        if ft:
            eprint("note: big artifacts carry no ftab; running without it")
        return BigIndex.load(prefix)
    eprint(f"loading: {prefix}")
    return RbtIndex.load(prefix, with_sa=sa, with_ma=ma, with_dl=dl, with_ft=ft)


def device_index(idx, sa=False, ma=False):
    """Device view.  For RbtIndex the component gating already happened at
    load time; a BigIndex mmap-loads everything on host and gates here."""
    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.engine.device import DeviceIndex

    if isinstance(idx, BigIndex):
        return idx.device_index(with_locate=sa and idx.has_locate,
                                with_markers=ma and idx.has_markers)
    return DeviceIndex.from_index(idx)


def iter_query_batches(idx: RbtIndex, fastq: str, batch_size: int,
                       normalize: bool = False, with_rc: bool = False,
                       use_native: bool = True, max_read_len: int = 1024):
    """Yield (names, qcodes, lengths) per batch; with_rc interleaves each
    read's forward and reverse-complement as adjacent lanes (2B total).
    Lane counts are padded to the fixed batch size (pad lanes have length 0)
    so jit compiles once per L bucket.  Uses the native C++ reader/encoder
    (native/fastq_reader.cpp) when built, else the Python fallback."""
    from rowbowt_tpu.io.fastq import NativeBatchReader

    if use_native and NativeBatchReader.available():
        yield from NativeBatchReader(
            fastq, idx.alpha.encode_table(), batch_size, with_rc=with_rc,
            normalize=normalize, max_read_len=max_read_len,
        )
        return

    from rowbowt_tpu.alphabet import normalize_read, revcomp

    for recs in batched(read_seqs(fastq), batch_size):
        names = [name for name, _, _ in recs]
        seqs = []
        for _, seq, _ in recs:
            s = normalize_read(seq) if normalize else np.frombuffer(seq, np.uint8)
            seqs.append(s)
            if with_rc:
                seqs.append(revcomp(s))
        # pad the lane count to the fixed batch size so jit compiles once
        full = batch_size * (2 if with_rc else 1)
        seqs += [np.empty(0, np.uint8)] * (full - len(seqs))
        L = pow2_at_least(max((len(s) for s in seqs), default=1))
        qc, lens = encode_batch(idx, [s.tobytes() for s in seqs], pad_to=L)
        yield names, qc, lens
