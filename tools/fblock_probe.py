"""Probe: occ1 (2 elem gathers/step) vs fblock (2 row gathers + SWAR) vs the
old split dense path, end-to-end on the real 8M bench index, plus a raw
row-gather chain at chr21 scale (160M symbols) where occ1 cannot exist.

Run on the GPU: python tools/fblock_probe.py [part1|part2|all]
"""

import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
CACHE = os.path.join(REPO, ".cache", "bench_idx")

import jax
import jax.numpy as jnp

from rowbowt_tpu import runtime  # noqa: E402

runtime.init(allow_explicit_cpu=False)


def timeit(fn, *a, reps=3):
    jax.block_until_ready(fn(*a))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


def codes_from_bwt4(bwt4: np.ndarray, n: int) -> np.ndarray:
    w = bwt4.reshape(-1)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    nib = ((w[:, None] >> shifts) & np.uint32(15)).astype(np.int64)
    return nib.reshape(-1)[:n]


def part1():
    from rowbowt_tpu.construct.build import build_fblock
    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.index import RbtIndex

    idx = RbtIndex.load(CACHE)
    print("index loaded", file=sys.stderr)
    if idx.fblock is None:
        codes = codes_from_bwt4(idx.bwt4, idx.n)
        idx.fblock = build_fblock(codes, idx.A)
        print("fblock built", file=sys.stderr)
    text = np.load(os.path.join(CACHE, "text.npy"))
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(7)
    tab = idx.alpha.encode_table()

    full = DeviceIndex.from_index(idx)
    jax.block_until_ready(full.arrays["occ1_flat"])
    print("index on device", file=sys.stderr)
    for B in (32768, 131072):
        starts = rng.integers(0, len(text) - 101, size=B)
        reads = np.stack([text[s:s + 100] for s in starts])
        bad = ~np.isin(reads, acgt).all(axis=1)
        reads[bad] = reads[np.flatnonzero(~bad)[0]]
        qc = jnp.asarray(tab[reads.astype(np.int64)].astype(np.int32))
        ln = jnp.full(B, 100, dtype=jnp.int32)
        variants = {
            "occ1": {k: v for k, v in full.arrays.items() if k != "fblock"},
            "fblock": {k: v for k, v in full.arrays.items() if k != "occ1_flat"},
            "dense": {k: v for k, v in full.arrays.items()
                      if k not in ("occ1_flat", "fblock")},
        }
        ref = None
        for name, arrs in variants.items():
            print(f"variant {name} B={B}: start", file=sys.stderr)
            dx = DeviceIndex(arrs, full.n, full.R, full.A, full.ma_wsize,
                             full.ftab_k, full.acgt_codes)
            fn = jax.jit(lambda d, q, l: find_ranges(d, q, l, use_ftab=False))
            t = timeit(fn, dx, qc, ln)
            lo, hi = fn(dx, qc, ln)
            if ref is None:
                ref = (np.asarray(lo), np.asarray(hi))
            else:
                assert (np.asarray(lo) == ref[0]).all(), f"{name} mismatch"
            print(f"B={B:>7,} {name:>7}: {t*1e3:8.2f} ms  "
                  f"{B/t:>12,.0f} reads/s  {B*100/t/1e6:8.1f} M LF-steps/s")


def part2():
    """Raw dependent-chain gather rates at 8M-scale and 160M-scale tables."""
    rng = np.random.default_rng(0)
    K = 50
    for nb, label in ((62_500, "8M-sym"), (1_250_000, "160M-sym"), (7_000_000, "900M-sym")):
        fb = jnp.asarray(rng.integers(0, 1 << 30, size=(nb, 24), dtype=np.int32))
        elem = jnp.asarray(rng.integers(0, 1 << 30, size=nb * 24, dtype=np.int32))

        @jax.jit
        def chain_row(i0, fb=fb, nb=nb):
            def body(t, i):
                r1 = fb[i]
                r2 = fb[(i * 7 + 13) % nb]
                v = jnp.sum(r1[:, :8] ^ r2[:, :8], axis=1).astype(jnp.uint32)
                return (v * jnp.uint32(2654435761) + t.astype(jnp.uint32)) % nb
            return jnp.sum(jax.lax.fori_loop(0, K, body, i0))

        @jax.jit
        def chain_elem(i0, elem=elem, nb=nb):
            m = nb * 24
            def body(t, i):
                v1 = elem[i]
                v2 = elem[(i * 7 + 13) % m]
                v = (v1 ^ v2).astype(jnp.uint32)
                return (v * jnp.uint32(2654435761) + t.astype(jnp.uint32)) % m
            return jnp.sum(jax.lax.fori_loop(0, K, body, i0.astype(jnp.uint32) % m))

        for B in (32768, 131072, 524288):
            i0 = jnp.asarray(rng.integers(0, nb, size=B, dtype=np.int32)).astype(jnp.uint32) % nb
            tr = timeit(chain_row, i0)
            te = timeit(chain_elem, i0)
            print(f"{label:>9} B={B:>7,}: row96B {tr/K*1e3:7.3f} ms/step "
                  f"({2*B*K/tr/1e6:7.1f} M row-gathers/s) | elem4B {te/K*1e3:7.3f} ms/step "
                  f"({2*B*K/te/1e6:7.1f} M elem-gathers/s)")


def codes_from_fblock(fb: np.ndarray, n: int) -> np.ndarray:
    w = fb[:, 8:].astype(np.uint32).reshape(-1)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    nib = ((w[:, None] >> shifts) & np.uint32(15)).astype(np.int64)
    return nib.reshape(-1)[:n]


def part3():
    """Is the chr-scale LF loop at gather speed-of-light?

    (a) achieved count rate on the real chr fblock (120 MB, 96B rows);
    (b) raw dependent-chain 2-row-gather rate on the SAME table (the
        speed-of-light bound: an LF step cannot beat two dependent gathers);
    (c) the 64-symbol/64B-row layout lever: half the symbols per row, 2/3 the
        bytes per gather, 2x the rows — win or lose?
    """
    from rowbowt_tpu.construct.build import DENSE_BLOCK
    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.index import RbtIndex

    cache = os.path.join(REPO, ".cache", "bench_idx_chr")
    idx = RbtIndex.load(cache)
    assert idx.fblock is not None
    n, A = idx.n, idx.A
    nb = idx.fblock.shape[0]
    print(f"chr index: n={n:,}, fblock {nb:,} rows x 96B "
          f"= {nb*96/2**20:.0f} MB", file=sys.stderr)
    text = np.load(os.path.join(cache, "text.npy"), mmap_mode="r")
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    rng = np.random.default_rng(7)
    tab = idx.alpha.encode_table()
    B = 131_072
    starts = rng.integers(0, len(text) - 101, size=B)
    reads = np.stack([text[s:s + 100] for s in starts])
    bad = ~np.isin(reads, acgt).all(axis=1)
    reads[bad] = reads[np.flatnonzero(~bad)[0]]
    qc = jnp.asarray(tab[reads.astype(np.int64)].astype(np.int32))
    ln = jnp.full(B, 100, dtype=jnp.int32)

    # (a) achieved: the production count loop on the chr fblock
    dx = DeviceIndex.from_index(idx).lean()
    fn = jax.jit(lambda d, q, l: find_ranges(d, q, l, use_ftab=False))
    ta = timeit(fn, dx, qc, ln)
    lo_ref, hi_ref = map(np.asarray, fn(dx, qc, ln))
    print(f"(a) achieved fblock96 count: {B/ta:>12,.0f} reads/s  "
          f"{2*B*100/ta/1e6:7.1f} M ranks/s")

    # (b) speed-of-light: dependent chain of 2 row gathers on the SAME table
    fbdev = dx.arrays["fblock"]
    K = 50

    @jax.jit
    def chain(i0):
        def body(t, i):
            r1 = fbdev[i]
            r2 = fbdev[(i * 7 + 13) % nb]
            v = jnp.sum(r1[:, :8] ^ r2[:, :8], axis=1).astype(jnp.uint32)
            return ((v * jnp.uint32(2654435761) + t.astype(jnp.uint32))
                    % nb).astype(jnp.int32)
        return jnp.sum(jax.lax.fori_loop(0, K, body, i0))

    i0 = jnp.asarray(rng.integers(0, nb, size=B, dtype=np.int32))
    tb = timeit(chain, i0)
    print(f"(b) raw 2-row-gather chain : {2*B*K/tb/1e6:7.1f} M row-gathers/s "
          f"-> LF ceiling {B*K/tb:>12,.0f} reads-steps/s "
          f"(achieved = {100*ta and (2*B*100/ta)/(2*B*K/tb)*100:.0f}% of SoL)")

    # (c) the 64-symbol/64B-row lever
    codes = codes_from_fblock(idx.fblock, n)
    SB = 64
    nb64 = (n + SB - 1) // SB
    padded = np.full(nb64 * SB, 15, dtype=np.uint32)
    padded[:n] = codes.astype(np.uint32)
    grp = padded.reshape(-1, 8)
    shifts = (np.arange(8, dtype=np.uint32) * 4)[None, :]
    words = (grp << shifts).astype(np.uint32).sum(axis=1, dtype=np.uint32)
    pc = padded.reshape(nb64, SB)
    fb64 = np.zeros((nb64, 16), dtype=np.int32)
    for c in range(A):
        fb64[1:, c] = np.cumsum((pc == c).sum(axis=1))[:-1]
    fb64[:, 8:] = words.reshape(nb64, 8).view(np.int32)
    fb64 = jnp.asarray(fb64)
    Fp = np.zeros(9, dtype=np.int32)  # pad F (len A+1) to 8 counts + sentinel
    Fp[: idx.F.shape[0]] = idx.F.astype(np.int32)
    Fp[idx.F.shape[0]:] = idx.F[-1]
    F64 = jnp.asarray(Fp)
    print(f"fb64 table: {nb64:,} rows x 64B = {nb64*64/2**20:.0f} MB",
          file=sys.stderr)
    NIB = 0x11111111

    def rank64(i, c):
        isafe = jnp.minimum(i, n - 1)
        blk = isafe // SB
        off = isafe - blk * SB
        row = fb64[blk]
        sel = jnp.arange(8, dtype=jnp.int32)[None, :] == c[:, None]
        occ = jnp.sum(jnp.where(sel, row[:, :8], 0), axis=1, dtype=jnp.int32)
        w = jax.lax.bitcast_convert_type(row[:, 8:], jnp.uint32)
        pat = (c.astype(jnp.uint32) * NIB)[:, None]
        x = w ^ pat
        t = x | (x >> 1) | (x >> 2) | (x >> 3)
        match = (~t) & jnp.uint32(NIB)
        kn = jnp.clip(off[:, None] - 8 * jnp.arange(8, dtype=off.dtype)[None, :], 0, 8)
        mask = jnp.where(kn >= 8, jnp.uint32(0xFFFFFFFF),
                         (jnp.uint32(1) << (4 * kn.astype(jnp.uint32))) - 1)
        inblk = jnp.sum(jax.lax.population_count(match & mask), axis=1,
                        dtype=jnp.int32)
        v = occ + inblk.astype(occ.dtype)
        v = jnp.where(i >= n, F64[c + 1] - F64[c], v)
        return jnp.where(c < 0, 0, v)

    @jax.jit
    def count64(qc, ln):
        Bq, L = qc.shape
        lo = jnp.zeros(Bq, jnp.int32)
        hi = jnp.full(Bq, n - 1, jnp.int32)
        done = jnp.zeros(Bq, bool)

        def body(j, st):
            lo, hi, done = st
            c = qc[:, L - 1 - j]
            act = (~done) & (j < ln)
            csafe = jnp.maximum(c, 0)
            cb = rank64(lo, csafe)
            ci = rank64(hi + 1, csafe) - cb
            sel = jnp.arange(8, dtype=jnp.int32)[None, :] == csafe[:, None]
            nlo = jnp.sum(jnp.where(sel, F64[None, :8], 0), axis=1,
                          dtype=jnp.int32) + cb
            nhi = nlo + ci - 1
            empty = (ci <= 0) | (c < 0)
            nlo = jnp.where(empty, 1, nlo)
            nhi = jnp.where(empty, 0, nhi)
            lo = jnp.where(act, nlo, lo)
            hi = jnp.where(act, nhi, hi)
            return lo, hi, done | (act & empty)

        lo, hi, _ = jax.lax.fori_loop(0, L, body, (lo, hi, done))
        return lo, hi

    tc = timeit(lambda q, l: count64(q, l)[0], qc, ln)
    lo64, hi64 = map(np.asarray, count64(qc, ln))
    assert (lo64 == lo_ref).all() and (hi64 == hi_ref).all(), "fb64 mismatch"
    print(f"(c) fb64 (64B rows) count  : {B/tc:>12,.0f} reads/s  "
          f"{2*B*100/tc/1e6:7.1f} M ranks/s  ({ta/tc:.2f}x vs fblock96)")


def part4():
    """Gather ceiling on the n=2.4G (> 2^31) fb2 table: is the big count
    rate (bench[big]) at the dependent-2-row-gather speed of light for a
    1.68 GB table, or is the two-level (base + local checkpoint) rank
    leaving throughput on the floor?"""
    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.engine.count import find_ranges

    big = BigIndex.load(os.path.join(REPO, ".cache", "bench_idx_big"))
    dx = big.device_index()
    fb2 = dx.arrays["fb2"]
    nb = fb2.shape[0]
    print(f"big index: n={big.n:,}, fb2 {nb:,} rows x 96B "
          f"= {nb*96/2**30:.2f} GB", file=sys.stderr)
    rng = np.random.default_rng(7)
    qcodes = np.load(os.path.join(REPO, ".cache", "bench_idx_big", "qcodes.npy"))
    lens = np.load(os.path.join(REPO, ".cache", "bench_idx_big", "qlens.npy"))
    B = 131_072
    qc = jnp.asarray(qcodes[:B].astype(np.int32))
    ln = jnp.asarray(lens[:B].astype(np.int32))

    # (a) achieved: the production big-count loop
    fn = jax.jit(lambda d, q, l: find_ranges(d, q, l, use_ftab=False))
    ta = timeit(fn, dx, qc, ln)
    print(f"(a) achieved fb2 count     : {B/ta:>12,.0f} reads/s  "
          f"{2*B*100/ta/1e6:7.1f} M ranks/s")

    # (b) speed-of-light: dependent chain of 2 row gathers on the SAME table
    K = 50

    @jax.jit
    def chain(i0):
        def body(t, i):
            r1 = fb2[i]
            r2 = fb2[(i * 7 + 13) % nb]
            v = jnp.sum(r1[:, :8] ^ r2[:, :8], axis=1).astype(jnp.uint32)
            return ((v * jnp.uint32(2654435761) + t.astype(jnp.uint32))
                    % nb).astype(jnp.int32)
        return jnp.sum(jax.lax.fori_loop(0, K, body, i0))

    i0 = jnp.asarray(rng.integers(0, nb, size=B, dtype=np.int32))
    tb = timeit(chain, i0)
    sol = 2 * B * K / tb
    ach = 2 * B * 100 / ta
    print(f"(b) raw 2-row-gather chain : {sol/1e6:7.1f} M row-gathers/s "
          f"-> achieved = {ach/sol*100:.0f}% of SoL")


if __name__ == "__main__":
    which = sys.argv[1] if len(sys.argv) > 1 else "all"
    print("device:", jax.devices()[0], file=sys.stderr)
    if which in ("part1", "all"):
        part1()
    if which in ("part2", "all"):
        part2()
    if which in ("part3",):
        part3()
    if which in ("part4",):
        part4()
