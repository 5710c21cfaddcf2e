"""rbt_locs — locate-then-positional-markers (rb_locs / rb_markers_tsa
equivalent, src/rb_markers_tsa.cpp:76-128).

Greedy-seed locate via the toehold SA, then look up markers by TEXT position
span [l, l+readlen-1] in the positional marker index (<inpre>.midx, built by
rbt_midx — the rle_window_arr replacement).  Output per read
(rb_markers_tsa.cpp:76-88):

    <name>[ <seq>/<pos>/<allele>]...
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from rowbowt_tpu import runtime
from rowbowt_tpu.cli.common import (
    device_index, eprint, iter_query_batches, load_index,
)
from rowbowt_tpu.index import marker_allele, marker_pos, marker_seq
from rowbowt_tpu.midx import PosMarkers


def main(argv=None):
    p = argparse.ArgumentParser(prog="rbt_locs", description=__doc__)
    p.add_argument("inpre")
    p.add_argument("fastq")
    p.add_argument("-w", "--wsize", type=int, default=19,
                   help="greedy seed min length")
    p.add_argument("-m", "--max-hits", type=int, default=4)
    p.add_argument("-o", "--output-prefix", dest="outpre", default=None)
    p.add_argument("-b", "--batch-size", type=int, default=4096)
    args = p.parse_args(argv)
    runtime.init()

    idx = load_index(args.inpre, sa=True, dl=True)
    midx_path = args.inpre.rstrip("/") + ".midx.npz"
    try:
        midx = PosMarkers.load(midx_path)
    except FileNotFoundError:
        eprint(f"error: positional marker index not found: {midx_path} "
               "(build it with rbt_midx or rbt_build -m)")
        return 1
    if idx.samples_last is None:
        eprint("error: index has no toehold SA (build with -s); "
               "rbt_locs needs locate support")
        return 1
    dx = device_index(idx, sa=True)

    import jax.numpy as jnp

    from rowbowt_tpu.cli.common import Timer, pow2_at_least
    from rowbowt_tpu.engine.seeds import locate_from_longest_seed, seeds_greedy_w_sample
    from rowbowt_tpu.midx import at_ranges_batched

    mpos, mval = midx.device()
    out = sys.stdout
    t_query = Timer()
    n_reads = 0
    for names, qc, lens in iter_query_batches(idx, args.fastq, args.batch_size):
        n_reads += len(names)
        res = seeds_greedy_w_sample(dx, qc, lens, min_length=args.wsize)
        locs, cnt = locate_from_longest_seed(dx, *res, max_hits=args.max_hits)
        # every (read, location) pair probes the positional markers in ONE
        # [B*max_hits]-batched two-searchsorted kernel (rle_window_arr::
        # at_range per hit, rb_markers_tsa.cpp:82) — the per-read host loop
        # was the serial bottleneck at real locate throughput
        lens_d = jnp.asarray(np.asarray(lens))
        flat_l = locs.reshape(-1)
        flat_r = flat_l + jnp.repeat(lens_d, locs.shape[1]) - 1
        safe = flat_l >= 0
        mk = 8
        while True:
            vals, mcnt = at_ranges_batched(
                mpos, mval, jnp.where(safe, flat_l, 0),
                jnp.where(safe, flat_r, -1), mk)
            mcnt_h = np.asarray(mcnt)
            if mcnt_h.max(initial=0) <= mk:
                break
            mk = pow2_at_least(int(mcnt_h.max()), floor=mk)
        vals_h = np.asarray(vals)
        cnt_h = np.asarray(cnt)
        H = locs.shape[1]
        for b, name in enumerate(names):
            parts = [name]
            for j in range(int(cnt_h[b])):
                row = b * H + j
                for t in range(int(mcnt_h[row])):
                    m = np.int64(vals_h[row, t])
                    parts.append(
                        f" {int(marker_seq(m))}/{int(marker_pos(m))}/"
                        f"{int(marker_allele(m))}"
                    )
            out.write("".join(parts) + "\n")
    query_s = t_query.lap()
    if query_s > 0:
        eprint(f"meter: {n_reads/query_s:,.0f} reads/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
