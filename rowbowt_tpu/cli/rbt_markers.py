"""rbt_markers — marker genotyping (rb_markers equivalent, src/rb_markers.cpp).

Per read: N-normalize, query BOTH strands with greedy seeding (or --lmem),
emit one line per seed in MarkerSeed::print_buf format (rb_markers.cpp:250-261):

    <name> <range_size> <+|-> <query_start> <query_len> <seq/pos/allele ...| .>

Filter semantics mirror the reference exactly: the standard path sorts+uniques
markers per seed gated by --min-range; --heuristic additionally applies
--clear-conflicting / --clear-identical per seed, the early strand stop, and
the --best-strand-only / --min-seed-length seed filters (rb_markers.cpp:
440-463, 504-506).  Differences from the reference, both deterministic
improvements: output is in input-read order (the pthread pool interleaves
arbitrarily), and --heuristic starts with the forward strand instead of a
random one.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rowbowt_tpu import runtime
from rowbowt_tpu.alphabet import normalize_read
from rowbowt_tpu.cli.common import (
    Timer, device_index, eprint, iter_query_batches, load_index,
)
from rowbowt_tpu.engine.filters import (
    assemble_seeds, heuristic_stop, keep_seeds_best_strand, keep_seeds_by_len,
)


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_markers", description=__doc__)
    p.add_argument("inpre")
    p.add_argument("fastq")
    p.add_argument("-w", "--wsize", type=int, default=10)
    p.add_argument("-r", "--max-range", type=int, default=1000)
    p.add_argument("-m", "--min-range", type=int, default=0)
    p.add_argument("-t", "--threads", type=int, default=1,
                   help="accepted for parity; batching replaces the pool")
    p.add_argument("-u", "--max-tasks", type=int, default=1024,
                   help="accepted for parity")
    p.add_argument("-l", "--read-len", type=int, default=101)
    p.add_argument("-y", "--min-seed-length", type=int, default=0)
    p.add_argument("-f", "--ftab", action="store_true")
    p.add_argument("--lmem", action="store_true")
    p.add_argument("--overlap", action="store_true")
    p.add_argument("--heuristic", action="store_true")
    p.add_argument("--best-strand-only", action="store_true", dest="best_strand")
    p.add_argument("--clear-conflicting", action="store_true")
    p.add_argument("--clear-identical", action="store_true")
    p.add_argument("-x", "--fbb", action="store_true",
                   help="accepted for reference-CLI parity; the dense occ "
                        "tables are this design's fbb analog (see README)")
    p.add_argument("-b", "--batch-size", type=int, default=2048)
    p.add_argument("--max-seeds", type=int, default=8)
    p.add_argument("--max-markers", type=int, default=32)
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a jax profiler trace of the marker loop to DIR")
    args = p.parse_args(argv)
    runtime.init()

    if args.overlap:
        eprint("overlapped seeds currently broken")  # rb_markers.cpp:121-124
        return 1

    t = Timer()
    eprint("loading rowbowt + markers" + (" and ftab" if args.ftab else ""))
    idx = load_index(args.inpre, sa=False, ma=True, dl=False,
                     ft=args.ftab or args.lmem)
    if idx.ma_row is None:
        eprint("error: index has no marker array (build with -m)")
        return 1
    dx = device_index(idx, ma=True)
    eprint(f"loading rowbowt + markers took: {t.lap()} seconds")

    t = Timer()
    out = sys.stdout
    S, K = args.max_seeds, args.max_markers

    def filter_and_print(name, seq_len, seeds_by_strand):
        """Per-read filter pipeline (rb_markers.cpp:365-382 standard,
        :440-463 + :504-506 heuristic) over [("+", seeds), ("-", seeds)]."""
        read_len = args.read_len if args.heuristic else seq_len
        seeds = []
        stopped = False
        for _, ss in seeds_by_strand:
            if stopped:
                break
            for ms in ss:
                if args.heuristic:
                    if ms.query_len < args.min_seed_length:
                        continue  # heuristic out_fn drop (rb_markers.cpp:447)
                    if args.clear_conflicting:
                        ms.clear_if_conflicting(read_len)
                    if args.clear_identical:
                        ms.filter_identical_pos()
                seeds.append(ms)
                if args.heuristic and args.best_strand and heuristic_stop(
                        ms, read_len, args.min_seed_length):
                    stopped = True
                    break
        if args.heuristic:
            if args.best_strand:
                seeds = keep_seeds_best_strand(seeds)
            if args.min_seed_length:
                seeds = keep_seeds_by_len(seeds, args.min_seed_length)
        for ms in seeds:
            out.write(ms.print_buf() + "\n")

    import contextlib

    stack = contextlib.ExitStack()
    if args.profile:
        import jax.profiler

        stack.enter_context(jax.profiler.trace(args.profile))
    with stack:  # guarantees the trace flushes even if the loop raises
        if args.lmem:
            _run_lmem(args, idx, dx, K, filter_and_print)
        else:
            _run_greedy(args, idx, dx, S, K, filter_and_print)
    if args.profile:
        eprint(f"profiler trace written to {args.profile}")
    eprint(f"counting markers took: {t.lap()} seconds")
    return 0


def _run_greedy(args, idx, dx, S, K, filter_and_print):
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding

    # --heuristic --best-strand-only: the reference's heuristic worker only
    # computes the second strand when the first didn't stop early
    # (rb_markers.cpp:429-519).  Device form: forward-strand kernel first,
    # then ONE compacted reverse-strand batch holding only the reads that
    # didn't stop (lanes bucketed to powers of two) — the skipped lanes are
    # real saved LF work, not host post-filtering.  RBT_NO_STRAND_SKIP=1
    # forces the always-both-strands path (parity tests / A-B timing).
    import os

    heur_skip = (args.heuristic and args.best_strand
                 and not os.environ.get("RBT_NO_STRAND_SKIP"))

    def run_kernel(qc, lens):
        slo, shi, sqs, sqe, mids, mcnt, ns = map(
            np.asarray,
            markers_greedy_seeding(
                dx, qc, lens, wsize=args.wsize, max_range=args.max_range,
                max_seeds=S, max_k=K, use_ftab=args.ftab, values=False,
            ),
        )
        # resolve marker values on host: skips the kernel's biggest gather
        # (DESIGN.md cost anatomy) and halves the device->host transfer
        mvals = np.where(
            mids >= 0,
            idx.ma_val[np.clip(mids, 0, idx.ma_val.shape[0] - 1)], -1)
        return slo, shi, sqs, sqe, mvals, mcnt, ns

    for names, qc, lens in iter_query_batches(
        idx, args.fastq, args.batch_size, normalize=True,
        with_rc=not heur_skip,
    ):
        if heur_skip:
            _greedy_heuristic_batch(args, idx, names, qc, lens, K,
                                    run_kernel, filter_and_print)
            continue
        slo, shi, sqs, sqe, mvals, mcnt, ns = run_kernel(qc, lens)
        for ri, name in enumerate(names):
            rl = int(lens[2 * ri])
            per_strand = []
            for lane, strand in ((2 * ri, "+"), (2 * ri + 1, "-")):
                per_strand.append((strand, assemble_seeds(
                    name, strand, rl,
                    slo[lane], shi[lane], sqs[lane], sqe[lane],
                    mvals[lane], mcnt[lane], ns[lane],
                    min_range=args.min_range, max_k=K,
                )))
            filter_and_print(name, rl, per_strand)


def _greedy_heuristic_batch(args, idx, names, qc, lens, K, run_kernel,
                            filter_and_print):
    from rowbowt_tpu.cli.common import pow2_at_least
    from rowbowt_tpu.engine.filters import heuristic_stop

    qc = np.asarray(qc)
    lens = np.asarray(lens)
    f = run_kernel(qc, lens)
    read_len = args.read_len
    fwd_seeds = []
    need_rc = []
    for ri, name in enumerate(names):
        rl = int(lens[ri])
        ss = assemble_seeds(name, "+", rl, f[0][ri], f[1][ri], f[2][ri],
                            f[3][ri], f[4][ri], f[5][ri], f[6][ri],
                            min_range=args.min_range, max_k=K)
        fwd_seeds.append(ss)
        stopped = any(
            ms.query_len >= args.min_seed_length
            and heuristic_stop(ms, read_len, args.min_seed_length)
            for ms in ss)
        if not stopped:
            need_rc.append(ri)

    rc_seeds = {ri: [] for ri in range(len(names))}
    if need_rc:
        L = qc.shape[1]
        # reverse-complement in CODE space from the forward batch: comp
        # table over index codes, reverse, re-right-align
        comp = np.full(16, -1, dtype=qc.dtype)
        tab = idx.alpha.encode_table()
        for x, y in zip(b"ACGT", b"TGCA"):
            cx, cy = int(tab[x]), int(tab[y])
            if cx >= 0 and cy >= 0:
                comp[cx] = cy
        sub = qc[need_rc]
        sublens = lens[need_rc]
        rc_left = np.where(sub[:, ::-1] >= 0, comp[np.maximum(sub[:, ::-1], 0)], -1)
        shift = (L - sublens.astype(np.int64))[:, None]
        src = np.arange(L, dtype=np.int64)[None, :] - shift
        rc = np.where(src >= 0,
                      np.take_along_axis(rc_left, np.clip(src, 0, L - 1), 1), -1)
        nl = pow2_at_least(len(need_rc), floor=min(64, args.batch_size))
        pad = nl - len(need_rc)
        if pad:
            rc = np.concatenate([rc, np.full((pad, L), -1, rc.dtype)])
            sublens = np.concatenate([sublens, np.zeros(pad, sublens.dtype)])
        r = run_kernel(rc, sublens)
        for j, ri in enumerate(need_rc):
            rl = int(lens[ri])
            rc_seeds[ri] = assemble_seeds(
                names[ri], "-", rl, r[0][j], r[1][j], r[2][j], r[3][j],
                r[4][j], r[5][j], r[6][j], min_range=args.min_range, max_k=K)
    for ri, name in enumerate(names):
        filter_and_print(name, int(lens[ri]),
                         [("+", fwd_seeds[ri]), ("-", rc_seeds[ri])])


def _run_lmem(args, idx, dx, K, filter_and_print):
    """--lmem: one kernel lane per (read, strand, start offset) prefix; each
    lane emits at most one seed (rowbowt.hpp:341-404)."""
    from rowbowt_tpu.alphabet import revcomp
    from rowbowt_tpu.cli.common import pow2_at_least
    from rowbowt_tpu.engine.batch import encode_batch
    from rowbowt_tpu.engine.filters import MarkerSeed, _u64
    from rowbowt_tpu.engine.seeds import lmem_expand, markers_lmem_lanes
    from rowbowt_tpu.index import pack_marker  # noqa: F401  (markers prepacked)
    from rowbowt_tpu.io.fastq import batched, read_seqs

    for recs in batched(read_seqs(args.fastq), args.batch_size):
        strand_seqs = []   # (rec idx, strand, normalized seq)
        for ri, (_, seq, _) in enumerate(recs):
            s = normalize_read(seq)
            strand_seqs.append((ri, "+", s))
            strand_seqs.append((ri, "-", revcomp(s)))
        lane_reads, owner, _ = lmem_expand([s.tobytes() for _, _, s in strand_seqs])
        L = pow2_at_least(max((len(b) for b in lane_reads), default=1))
        qc, lens = encode_batch(idx, lane_reads, pad_to=L)
        elo, ehi, eqs, mvals, mcnt = map(
            np.asarray,
            markers_lmem_lanes(dx, qc, lens, wsize=args.wsize,
                               max_range=args.max_range, max_k=K),
        )
        # group lanes back per (read, strand) in koff order
        per_rec: dict[int, list] = {ri: [("+", []), ("-", [])] for ri in range(len(recs))}
        for j, own in enumerate(owner):
            ri, strand, s = strand_seqs[own]
            if ehi[j] < elo[j]:
                continue  # out_fn drops empty ranges
            name = recs[ri][0]
            qs, qe = int(eqs[j]), len(lane_reads[j]) - 1
            query_start = len(s) - qs - 1 if strand == "-" else qs
            markers: list[int] = []
            rs = _u64(int(ehi[j]) - int(elo[j]) + 1)
            if rs >= args.min_range and int(mcnt[j]) > 0:
                markers = sorted({int(v) for v in mvals[j, : min(int(mcnt[j]), K)]
                                  if v != -1})
            ms = MarkerSeed(name, strand, rs, query_start,
                            _u64(qe - qs + 1), markers)
            per_rec[ri][0 if strand == "+" else 1][1].append(ms)
        for ri, (name, seq, _) in enumerate(recs):
            filter_and_print(name, len(seq), per_rec[ri])


if __name__ == "__main__":
    sys.exit(main())
