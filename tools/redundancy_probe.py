"""The r-index exists because real panels have r << n.

Builds panels over ONE 1 Mbp reference with growing haplotype counts (the
same variant scheme as bench.py's small config: 3,000 sites, each hap carries
each variant w.p. 0.5) and records, per panel:

  n, R, n/R;
  bytes of the O(n) dense backend (fblock64 rank rows + kval + phi1 — what
    the replicated dense fast path keeps in device memory);
  bytes of the O(R) run-space backend (run tables + occ[A,R] + boundary
    samples + phi predecessor tables — the rle_string/toehold_sa space
    regime, rle_string.hpp:10-13);
  measured count reads/s on BOTH backends (one real chip).

Expectation: text grows ~linearly with haplotypes while R barely moves, so
the O(R) tables' memory stays flat where the dense tables grow linearly —
the reference's core claim, reproduced on the GPU with the throughput
cost of the compressed backend quantified.

Run:  python tools/redundancy_probe.py [--haps 8,32,128]
"""

import argparse
import os
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

REF_LEN = 1_000_000
N_VARS = 3_000
SEED = 1234
W = 10
B = 65_536
READ_LEN = 100


def timeit(fn, *a, reps=3):
    import jax

    jax.block_until_ready(fn(*a))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


def build_panel_text(rng, n_haps):
    from rowbowt_tpu.alphabet import SEP_BYTE, TERM_BYTE

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=REF_LEN)
    var_pos = np.sort(rng.choice(REF_LEN, size=N_VARS, replace=False))
    var_alt = rng.choice(acgt, size=N_VARS)
    sep = np.full(W, SEP_BYTE, dtype=np.uint8)
    parts = [ref, sep]
    for _ in range(n_haps):
        hap = ref.copy()
        carry = rng.random(N_VARS) < 0.5
        hap[var_pos[carry]] = var_alt[carry]
        parts += [hap, sep]
    parts.append(np.array([TERM_BYTE], dtype=np.uint8))
    return np.concatenate(parts)


def dense_bytes(idx):
    """O(n) replicated fast-path footprint: fb64 rank rows + kval + phi1."""
    total = 0
    if idx.fblock is not None:
        total += idx.fblock.shape[0] * 2 * 64  # 64B-row repack, 2 rows/96B row
    for a in (idx.kval, idx.phi1):
        if a is not None:
            total += a.nbytes
    return total


def runspace_bytes(idx):
    """O(R) backend footprint: run tables + occ + boundary samples + phi."""
    total = 0
    for a in (idx.run_start, idx.run_head, idx.occ, idx.cruns_flat,
              idx.cruns_off, idx.samples_last, idx.pred_pos, idx.pred_to_run):
        if a is not None:
            total += a.nbytes
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--haps", default="8,32,128")
    args = ap.parse_args()

    import jax.numpy as jnp

    from rowbowt_tpu.construct.build import build_index
    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.device import DeviceIndex

    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    rows = []
    for n_haps in [int(x) for x in args.haps.split(",")]:
        rng = np.random.default_rng(SEED)
        text = build_panel_text(rng, n_haps)
        n = len(text)
        t0 = time.perf_counter()
        idx = build_index(text, dense=True)
        t_build = time.perf_counter() - t0
        # the run-space view of the same index: drop the dense tables
        import copy

        idx_rs = copy.copy(idx)
        idx_rs.fblock = idx_rs.bwt4 = idx_rs.occ_blk = None
        idx_rs.kval = idx_rs.phi1 = idx_rs.ltk = None

        starts = rng.integers(0, n - READ_LEN - W - 1, size=B)
        reads = np.stack([text[s:s + READ_LEN] for s in starts])
        bad = ~np.isin(reads, acgt).all(axis=1)
        reads[bad] = reads[np.flatnonzero(~bad)[0]]
        tab = idx.alpha.encode_table()
        qc = jnp.asarray(tab[reads.astype(np.int64)].astype(np.int32))
        ln = jnp.full(B, READ_LEN, dtype=jnp.int32)

        import jax

        fn = jax.jit(lambda d, q, l: find_ranges(d, q, l, use_ftab=False)[0].sum())
        dxd = DeviceIndex.from_index(idx).lean()
        td = timeit(fn, dxd, qc, ln)
        dxr = DeviceIndex.from_index(idx_rs)
        assert "fblock64" not in dxr.arrays and "occ1_flat" not in dxr.arrays
        tr = timeit(fn, dxr, qc, ln)
        del dxd, dxr

        db, rb = dense_bytes(idx), runspace_bytes(idx)
        rows.append((n_haps, n, idx.R, n / idx.R, db / 2**20, rb / 2**20,
                     B / td, B / tr, t_build))
        print(f"haps={n_haps:>3}  n={n:>11,}  R={idx.R:>9,}  n/R={n/idx.R:6.1f}  "
              f"dense={db/2**20:8.1f} MB  run-space={rb/2**20:7.1f} MB  "
              f"count {B/td:>9,.0f} (dense) vs {B/tr:>9,.0f} (run-space) reads/s",
              flush=True)

    print("\n| haps | n | R | n/R | dense MB (O(n)) | run-space MB (O(R)) | "
          "dense reads/s | run-space reads/s |")
    print("|---|---|---|---|---|---|---|---|")
    for h, n, R, nr, db, rb, rd, rr, _ in rows:
        print(f"| {h} | {n:,} | {R:,} | {nr:.1f} | {db:,.1f} | {rb:,.1f} | "
              f"{rd:,.0f} | {rr:,.0f} |")


if __name__ == "__main__":
    main()
