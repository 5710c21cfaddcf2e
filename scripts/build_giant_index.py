"""Build the n = 10^10 / 513-haplotype pangenome index (bench 'giant' config)
with the PFP toolchain (construct/pfp.py + native/pfp.cpp).

The panel: 19.5 Mbp reference x (1 + 512) documents, one variant site per
~1000 bp, each haplotype carrying each site's alt with p = 0.5 — the shape of
a 1000G-project chromosome panel (hundreds of near-identical haplotypes).
n = 10,003,505,131 symbols: 4.2x past 2^31 *squared*-scale territory for the
chunked merge (a serial rank walk would need ~4 hours and ~200 GB; PFP builds
this in minutes because the dictionary is ~reference-sized and the parse is
n/100 tokens — the exact reason pfbwt exists, /root/reference/README.md:37-44).

Device tables use the 256-symbol/160B fb2 rows (0.63 B/symbol -> 6.0 GB; the
64B repack would be 10 GB) plus the O(R) bitmap-phi locate tables and the
O(M) marker CSR.  Which row layout serves this scale best on the GPU is not
measured yet.

Parity is ANALYTIC and fully independent of the construction: an unmutated
read sampled at reference offset q of document d matches document d' iff the
two documents agree on every variant site in [q, q+L) — so expected counts,
expected occurrence-position sets, and expected marker multisets follow from
the carry matrix alone.  The build asserts the CPU engine against all three.

Run once (~15-30 min, ~25 GB peak RSS): python scripts/build_giant_index.py
Output: .cache/bench_idx_giant/ consumed by bench.py's 'giant' worker.
"""

import json
import os
import resource
import shutil
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from rowbowt_tpu.alphabet import SEP_BYTE, TERM_BYTE, Alphabet  # noqa: E402
from rowbowt_tpu.construct import pfp  # noqa: E402

REF_LEN = 19_500_000
N_HAPS = 512
N_VARS = 19_500  # one site per ~1000 bp
SEED = 424_242
W = 10           # marker window AND parse window
PFP_P = 100      # trigger modulus: ~100-char phrases
N_READS = 262_144
READ_LEN = 100
N_PARITY = 512
OUT = os.path.join(REPO, ".cache", "bench_idx_giant")
TMP = OUT + ".building"


def main():
    rng = np.random.default_rng(SEED)
    t_all = time.perf_counter()
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=REF_LEN)
    var_pos = np.sort(rng.choice(REF_LEN, size=N_VARS, replace=False)
                      ).astype(np.int64)
    var_alt = rng.choice(acgt, size=N_VARS)
    # guarantee every alt differs from the reference base
    same = var_alt == ref[var_pos]
    var_alt[same] = acgt[(np.searchsorted(acgt, ref[var_pos[same]]) + 1) % 4]
    sep = np.full(W, SEP_BYTE, dtype=np.uint8)
    n_docs = N_HAPS + 1
    doc_len = REF_LEN + W
    n = n_docs * doc_len + 1
    print(f"giant: n = {n:,} ({n_docs} docs, {N_VARS:,} sites)",
          file=sys.stderr)

    # carry matrix: doc 0 = reference (all False)
    carry = np.zeros((n_docs, N_VARS), dtype=bool)
    carry[1:] = rng.random((N_HAPS, N_VARS)) < 0.5

    # read sampling plan: (doc, ref offset) pairs; first N_PARITY unmutated
    r_doc = rng.integers(0, n_docs, size=N_READS)
    r_off = rng.integers(0, REF_LEN - READ_LEN - 1, size=N_READS)
    reads = np.empty((N_READS, READ_LEN), dtype=np.uint8)

    # markers: every doc gets one marker per site (allele = carry)
    site_b = np.broadcast_to(var_pos, (n_docs, N_VARS))
    m_tpos = (np.arange(n_docs, dtype=np.int64)[:, None] * doc_len
              + site_b).ravel()
    m_packed = ((site_b.astype(np.int64) << 8)
                | carry.astype(np.int64)).ravel()
    probes = pfp.marker_window_positions(m_tpos, W)
    print(f"giant: {m_tpos.shape[0]:,} markers -> {probes.shape[0]:,} "
          f"window probes", file=sys.stderr)

    def gen_parts():
        for d in range(n_docs):
            doc = ref.copy()
            c = carry[d]
            doc[var_pos[c]] = var_alt[c]
            idx = np.flatnonzero(r_doc == d)
            for i in idx:
                reads[i] = doc[r_off[i]: r_off[i] + READ_LEN]
            if d < n_docs - 1:
                yield np.concatenate([doc, sep])
            else:
                yield np.concatenate([doc, sep,
                                      np.array([TERM_BYTE], dtype=np.uint8)])
            if d % 64 == 0:
                print(f"giant: fed doc {d}/{n_docs}", file=sys.stderr)

    t0 = time.perf_counter()
    res = pfp.pfp_construct(gen_parts(), w=W, p=PFP_P, probe_pos=probes,
                            verbose=True)
    t_pfp = time.perf_counter() - t0
    print(f"giant: pfp_construct {t_pfp:.1f}s (R={res.R:,})", file=sys.stderr)
    assert res.n == n

    alpha = Alphabet(np.unique(np.concatenate(
        [np.unique(ref), np.unique(var_alt),
         [np.uint8(SEP_BYTE), np.uint8(TERM_BYTE)]])))
    t0 = time.perf_counter()
    big = pfp.assemble_bigindex(res, alpha, block=256, verbose=True)
    pfp.attach_markers_from_probes(big, res, m_tpos, m_packed, W)
    big.doc_starts = np.arange(n_docs, dtype=np.int64) * doc_len
    big.doc_names = ["ref"] + [f"hap{h}" for h in range(N_HAPS)]
    t_asm = time.perf_counter() - t0
    print(f"giant: assemble {t_asm:.1f}s (fb2 {big.fb2.nbytes / 2**30:.2f} GB,"
          f" M={big.ma_row.shape[0]:,})", file=sys.stderr)

    # mutate 20% of the NON-parity reads (bench realism)
    mut = rng.random(N_READS) < 0.2
    mut[:N_PARITY] = False
    mpos = rng.integers(0, READ_LEN, size=N_READS)
    mchar = rng.choice(acgt, size=N_READS)
    reads[np.arange(N_READS)[mut], mpos[mut]] = mchar[mut]

    # ---- analytic oracle for the parity set (independent of construction):
    # read i (unmutated, from doc d at offset q) matches doc d' iff carry
    # agrees on every site in [q, q+L); window sites [q, q+W) give markers.
    exp_cnt = np.zeros(N_PARITY, dtype=np.int64)
    exp_pos_flat, exp_pos_off = [], [0]
    exp_mval_flat, exp_mval_off = [], [0]
    for i in range(N_PARITY):
        d, q = int(r_doc[i]), int(r_off[i])
        s0, s1 = np.searchsorted(var_pos, (q, q + READ_LEN))
        match = (carry[:, s0:s1] == carry[d, s0:s1]).all(axis=1)
        docs = np.flatnonzero(match)
        exp_cnt[i] = docs.shape[0]
        exp_pos_flat.append(docs.astype(np.int64) * doc_len + q)
        w1 = np.searchsorted(var_pos, q + W)
        vals = []
        for s in range(s0, w1):
            a = int(carry[d, s])
            vals.extend([int(var_pos[s] << 8 | a)] * docs.shape[0])
        exp_mval_flat.append(np.sort(np.array(vals, dtype=np.int64)))
        exp_pos_off.append(exp_pos_off[-1] + exp_pos_flat[-1].shape[0])
        exp_mval_off.append(exp_mval_off[-1] + exp_mval_flat[-1].shape[0])
    exp_pos_flat = np.concatenate(exp_pos_flat)
    exp_mval_flat = (np.concatenate(exp_mval_flat) if exp_mval_off[-1]
                     else np.empty(0, dtype=np.int64))
    assert exp_cnt.min() >= 1

    # ---- CPU engine vs the analytic oracle (validates the whole build) ----
    from rowbowt_tpu.cpu_backend import count_ranges_fb2g

    tab = alpha.encode_table()
    qcodes = tab[reads.astype(np.int64)].astype(np.int16)
    qlens = np.full(N_READS, READ_LEN, dtype=np.int32)
    t0 = time.perf_counter()
    exp_lo, exp_hi = count_ranges_fb2g(big, qcodes[:N_PARITY],
                                       qlens[:N_PARITY])
    t_cpu = time.perf_counter() - t0
    got = exp_hi - exp_lo + 1
    assert (got == exp_cnt).all(), \
        f"CPU counts != analytic oracle at {np.flatnonzero(got != exp_cnt)[:5]}"
    print(f"giant: CPU count == analytic oracle on {N_PARITY} reads "
          f"({N_PARITY / t_cpu:,.0f} reads/s 1t)", file=sys.stderr)
    # marker CSR vs the analytic multiset on the final ranges
    s = np.searchsorted(big.ma_row, exp_lo.astype(big.ma_row.dtype))
    e = np.searchsorted(big.ma_row, (exp_hi + 1).astype(big.ma_row.dtype))
    for i in range(N_PARITY):
        vals = np.sort(big.ma_val[s[i]:e[i]])
        expv = exp_mval_flat[exp_mval_off[i]:exp_mval_off[i + 1]]
        assert np.array_equal(vals, expv), f"marker multiset mismatch at {i}"
    print("giant: marker CSR == analytic multiset on all parity reads",
          file=sys.stderr)

    if os.path.isdir(TMP):
        shutil.rmtree(TMP)
    big.save(TMP)
    np.save(os.path.join(TMP, "qcodes.npy"), qcodes)
    np.save(os.path.join(TMP, "qlens.npy"), qlens)
    np.save(os.path.join(TMP, "expect_lo.npy"), exp_lo)
    np.save(os.path.join(TMP, "expect_hi.npy"), exp_hi)
    np.save(os.path.join(TMP, "expect_cnt.npy"), exp_cnt)
    np.save(os.path.join(TMP, "expect_pos_flat.npy"), exp_pos_flat)
    np.save(os.path.join(TMP, "expect_pos_off.npy"),
            np.array(exp_pos_off, dtype=np.int64))
    np.save(os.path.join(TMP, "expect_mval_flat.npy"), exp_mval_flat)
    np.save(os.path.join(TMP, "expect_mval_off.npy"),
            np.array(exp_mval_off, dtype=np.int64))
    # phi bitmap pack, precomputed so bench workers just mmap it
    t0 = time.perf_counter()
    big.prefix = TMP
    big._phi_pack()
    print(f"giant: phi pack {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    wall = time.perf_counter() - t_all
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    with open(os.path.join(TMP, "build_stats.json"), "w") as f:
        json.dump({"wall_s": round(wall, 1), "pfp_s": round(t_pfp, 1),
                   "assemble_s": round(t_asm, 1),
                   "peak_rss_gb": round(rss, 2), "n": n, "R": big.R,
                   "M": int(big.ma_row.shape[0]),
                   "n_docs": n_docs, "n_vars": N_VARS,
                   "cpu_reads_per_s_1t": round(N_PARITY / t_cpu, 1),
                   "parse": res.parse_stats}, f)
    if os.path.isdir(OUT):
        shutil.rmtree(OUT)
    os.rename(TMP, OUT)
    print(f"giant DONE: {wall:.1f}s total, peak RSS {rss:.2f} GB",
          file=sys.stderr)


if __name__ == "__main__":
    main()
