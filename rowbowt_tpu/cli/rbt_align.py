"""rbt_align — per-read count / locate / markers (rb_align equivalent).

Output is byte-identical to rb_align's rb_report (src/rb_align.cpp:118-145):
    <name> (<s>,<e>), count=<n>
    \\tlocs: <l>/<doc>:<off> ...          (-s; unbounded hits like the
                                           reference's max_hits = (uint64)-1)
    \\tmarkers: <pos>/<allele> ...        (-m; or the no-markers notice)
with the reference's quirks: empty range prints (1,0) count=0, locate order is
toehold-first-then-phi-chain, marker positions 0-based.  Load time and query
time go to stderr as "<load_s> <query_s>" (rb_align.cpp:164-192).
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rowbowt_tpu import runtime
from rowbowt_tpu.cli.common import (
    Timer, device_index, eprint, iter_query_batches, load_index, pow2_at_least,
)
from rowbowt_tpu.index import marker_allele, marker_pos


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_align", description=__doc__)
    p.add_argument("inpre", help="index prefix (directory)")
    p.add_argument("fastq")
    p.add_argument("-o", "--output-prefix", dest="outpre", default=None)
    p.add_argument("-s", "--sam", action="store_true",
                   help="also locate (loads toehold SA + doc list)")
    p.add_argument("-m", "--markers", action="store_true",
                   help="also report markers over the final range")
    p.add_argument("-x", "--fbb", action="store_true",
                   help="accepted for reference-CLI parity; the index "
                        "self-describes its backend, so this is a no-op here "
                        "(rank-only -x indexes simply lack the toehold SA)")
    p.add_argument("-b", "--batch-size", type=int, default=4096)
    p.add_argument("--max-hits", type=int, default=None,
                   help="cap located occurrences (default: unbounded)")
    p.add_argument("--profile", metavar="DIR", default=None,
                   help="write a jax profiler trace of the query loop to DIR "
                        "(view with tensorboard / xprof)")
    args = p.parse_args(argv)
    runtime.init()

    t_load = Timer()
    idx = load_index(args.inpre, sa=args.sam, ma=args.markers, dl=args.sam)
    if args.sam and idx.samples_last is None:
        eprint("error: index has no toehold SA (built with -x or without -s); "
               "locate is unavailable — mirror of fbb_string's no-select limit "
               "(fbb_string.hpp:55-59)")
        return 1
    if args.markers and idx.ma_row is None:
        eprint("error: index has no marker array (build with -m); "
               "marker queries are unavailable")
        return 1
    dx = device_index(idx, sa=args.sam, ma=args.markers)
    load_s = t_load.lap()

    out = sys.stdout
    t_query = Timer()
    import contextlib

    stack = contextlib.ExitStack()
    if args.profile:
        import jax.profiler

        stack.enter_context(jax.profiler.trace(args.profile))
    with stack:  # guarantees the trace flushes even if the loop raises
        n_reads, n_chars = _query_loop(args, idx, dx, out)
    if args.profile:
        eprint(f"profiler trace written to {args.profile}")
    query_s = t_query.lap()
    # the reference's "<load_s> <query_s>" stderr line (rb_align.cpp:164-192),
    # plus the BASELINE.md meters
    eprint(f"{load_s} {query_s}")
    if query_s > 0:
        eprint(f"meter: {n_reads/query_s:,.0f} reads/s, "
               f"{n_chars/query_s/1e6:,.1f} M LF-steps/s")
    return 0


def _query_loop(args, idx, dx, out):
    import jax.numpy as jnp

    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.locate import (
        find_ranges_w_toehold, locate_ragged, resolve_docs,
    )
    from rowbowt_tpu.engine.markers import markers_for_ranges

    n_reads = 0
    n_chars = 0
    for names, qc, lens in iter_query_batches(idx, args.fastq, args.batch_size):
        n_reads += len(names)
        n_chars += int(np.asarray(lens).sum())
        if args.sam:
            lo, hi, k = find_ranges_w_toehold(dx, qc, lens)
        else:
            lo, hi = find_ranges(dx, qc, lens)
        # pad lanes (length 0, past the batch's reads) hold the full range:
        # empty them, or locate and markers would expand all n rows of each
        real = jnp.arange(lo.shape[0]) < len(names)
        lo, hi = jnp.where(real, lo, 1), jnp.where(real, hi, 0)
        lo_h, hi_h = np.asarray(lo), np.asarray(hi)
        if args.sam:
            # the reference locates the WHOLE range (max_hits = -1); the
            # bucketed ragged walk allocates O(total hits), so one huge-range
            # lane no longer inflates the whole batch
            flat, foffs = locate_ragged(dx, lo, hi, k, max_hits=args.max_hits)
            if "doc_starts" in dx.arrays and flat.size:
                fdocs, fdoff = resolve_docs(dx, jnp.asarray(flat))
                fdocs, fdoff = np.asarray(fdocs), np.asarray(fdoff)
            else:  # index built without a doc list: print raw positions
                fdocs, fdoff = np.zeros_like(flat), flat
        if args.markers:
            mvals, mcnt = markers_for_ranges(dx, lo, hi, max_k=64)
            mvals, mcnt = np.asarray(mvals), np.asarray(mcnt)
            if mcnt.max(initial=0) > mvals.shape[1]:
                # the reference prints EVERY marker in the range
                # (rb_align.cpp:137-144) — re-probe at the batch's true width
                mk = pow2_at_least(int(mcnt.max()), floor=64)
                mvals, mcnt = markers_for_ranges(dx, lo, hi, max_k=mk)
                mvals, mcnt = np.asarray(mvals), np.asarray(mcnt)

        for b, name in enumerate(names):
            s, e = int(lo_h[b]), int(hi_h[b])
            cnt = e - s + 1 if e >= s else 0  # (1,0) -> 0 (rb_align.cpp:122)
            out.write(f"{name} ({s},{e}), count={cnt}\n")
            if args.sam:
                parts = ["\tlocs: "]
                for j in range(int(foffs[b]), int(foffs[b + 1])):
                    l = int(flat[j])
                    dn = idx.doc_names[int(fdocs[j])] if idx.doc_names else "?"
                    parts.append(f"{l}/{dn}:{int(fdoff[j])} ")
                out.write("".join(parts) + "\n")
            if args.markers:
                parts = ["\tmarkers: "]
                n_m = int(mcnt[b])
                if n_m == 0:
                    parts.append("no markers (consider building the marker "
                                 "array with a larger window size)")
                for j in range(n_m):
                    m = np.int64(mvals[b, j])
                    parts.append(f"{int(marker_pos(m))}/{int(marker_allele(m))} ")
                out.write("".join(parts) + "\n")
    return n_reads, n_chars


if __name__ == "__main__":
    sys.exit(main())
