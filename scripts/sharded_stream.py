"""Config-5 driver: STREAMED FASTQ over a SHARDED index on a (dp x idx) mesh.

The 1000G deployment shape (BASELINE.md config 5): every host runs this same
script; each host streams its own FASTQ shard (no cross-host input path), the
index is position-sharded over the 'idx' axis (parallel/sharded_dense.py) and
replicated over 'dp'; per-batch results gather to host 0 in read order (the
rb_align ordering guarantee).

Single-process it degenerates to one host's slice of the same program, so the
whole path runs on the virtual CPU mesh (tests/test_cli.py) and on one real
chip unchanged:

    python scripts/sharded_stream.py IDX_PREFIX READS.fq \
        [--n-idx 4] [--batch-size 4096] [-m] \
        [--coordinator host0:1234 --num-processes N --process-id i]
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("inpre")
    p.add_argument("fastq", help="this host's FASTQ shard")
    p.add_argument("--n-idx", type=int, default=1)
    p.add_argument("-b", "--batch-size", type=int, default=4096)
    p.add_argument("-m", "--markers", action="store_true")
    p.add_argument("--greedy", action="store_true",
                   help="greedy-seeding genotyping (the rb_markers "
                        "production path), fwd+revcomp per read")
    p.add_argument("--wsize", type=int, default=10)
    p.add_argument("--max-range", type=int, default=1000)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-processes", type=int, default=1)
    p.add_argument("--process-id", type=int, default=0)
    args = p.parse_args(argv)

    # distributed init MUST precede anything that initializes the jax
    # backend (even a module-level jnp constant in an engine import)
    from rowbowt_tpu.parallel import multihost as mh

    mh.init(args.coordinator, args.num_processes, args.process_id)
    from rowbowt_tpu import runtime

    runtime.init()  # after distributed init, which must precede the backend

    import numpy as np

    from rowbowt_tpu.cli.common import iter_query_batches
    from rowbowt_tpu.index import RbtIndex, marker_allele, marker_pos
    from rowbowt_tpu.parallel.sharded_dense import (
        ShardedDenseIndex,
        find_ranges_sharded_dense,
        find_ranges_w_markers_sharded_dense,
        markers_greedy_seeding_sharded_dense,
    )
    from rowbowt_tpu.bigindex import BigIndex

    want_ma = args.markers or args.greedy

    mesh = mh.global_mesh(n_idx=args.n_idx)
    if BigIndex.is_big_dir(args.inpre):
        # the big two-level artifact: its superblock layout IS the shard
        # layout (n_idx must equal n_sup); O(R)/O(M) aux tables replicate
        idx = BigIndex.load(args.inpre)
        if args.n_idx != idx.n_sup:
            print(f"error: big artifact is packed for n_idx == {idx.n_sup} "
                  f"(its superblock count); got --n-idx {args.n_idx}",
                  file=sys.stderr)
            return 1
        if want_ma and not idx.has_markers:
            print("error: index has no marker array (build with -m)",
                  file=sys.stderr)
            return 1
        sdx = idx.sharded_index()
    else:
        idx = RbtIndex.load(args.inpre, with_ma=want_ma)
        if want_ma and idx.ma_row is None:
            print("error: index has no marker array (build with -m)",
                  file=sys.stderr)
            return 1
        sdx = ShardedDenseIndex.build(idx, n_idx=args.n_idx)
        if want_ma and sdx.ms2 is None:
            print("error: index markers lack the dense ma_start1 table "
                  "(rebuild with dense=True)", file=sys.stderr)
            return 1
    tables = sdx.device_put(mesh)
    n_dp = mesh.shape["dp"]
    out = sys.stdout

    if args.greedy:
        comp = complement_codes(idx.alpha)

    for names, qc, lens in iter_query_batches(idx, args.fastq, args.batch_size):
        B = len(names)
        if args.greedy:
            inter, ilens = revcomp_lanes(qc, lens, comp, B)
            pad = (-(2 * B)) % n_dp
            if pad:
                inter = np.concatenate(
                    [inter, np.full((pad, L), -1, inter.dtype)])
                ilens = np.concatenate([ilens, np.zeros(pad, ilens.dtype)])
            gqc = mh.host_batch_to_global(mesh, inter.astype(np.int32))
            glen = mh.host_batch_to_global(mesh, ilens.astype(np.int32))
            slo, shi, sqs, sqe, mvals, mcnt, ns = \
                markers_greedy_seeding_sharded_dense(
                    mesh, sdx, tables, gqc, glen, wsize=args.wsize,
                    max_range=args.max_range)
            ns_h = mh.my_rows(ns, inter.shape[0])
            mv_h = mh.my_rows(mvals, inter.shape[0])
            mc_h = mh.my_rows(mcnt, inter.shape[0])
            for line in greedy_lines(names, mv_h, mc_h, ns_h):
                out.write(line + "\n")
            continue
        pad = (-B) % n_dp
        if pad:
            qc = np.concatenate([qc, np.full((pad, qc.shape[1]), -1, qc.dtype)])
            lens = np.concatenate([lens, np.zeros(pad, lens.dtype)])
        gqc = mh.host_batch_to_global(mesh, qc.astype(np.int32))
        glen = mh.host_batch_to_global(mesh, lens.astype(np.int32))
        if args.markers:
            lo, hi, buf, used, ovf = find_ranges_w_markers_sharded_dense(
                mesh, sdx, tables, gqc, glen, wsize=args.wsize, max_k=32)
            buf_h = mh.my_rows(buf, qc.shape[0])
            used_h = mh.my_rows(used, qc.shape[0])
        else:
            lo, hi = find_ranges_sharded_dense(mesh, sdx, tables, gqc, glen)
        # every host WRITES ITS OWN shard's results, in its own input order
        # (only this host knows its read names; cross-host rows would need a
        # name exchange the reference's single-node design never defines)
        lo_h = mh.my_rows(lo, qc.shape[0])
        hi_h = mh.my_rows(hi, qc.shape[0])
        for b, name in enumerate(names):
            s, e = int(lo_h[b]), int(hi_h[b])
            cnt = e - s + 1 if e >= s else 0
            out.write(f"{name} ({s},{e}), count={cnt}\n")
            if args.markers:
                K = buf_h.shape[1]
                got = [int(x) for x in buf_h[b, K - int(used_h[b]):]]
                parts = ["\tmarkers: "] + [
                    f"{int(marker_pos(np.int64(v)))}/"
                    f"{int(marker_allele(np.int64(v)))} " for v in got]
                out.write("".join(parts) + "\n")
    return 0


def complement_codes(alpha):
    """int64[16]: index code -> code of its complement base (-1 if none)."""
    import numpy as np

    tab = alpha.encode_table()
    comp = np.full(16, -1, dtype=np.int64)
    for x, y in zip(b"ACGT", b"TGCA"):
        cx, cy = int(tab[x]), int(tab[y])
        if cx >= 0 and cy >= 0:
            comp[cx] = cy
    return comp


def revcomp_lanes(qc, lens, comp, n_reads):
    """fwd+rc interleaved lanes (rb_markers.cpp:396-400) of the first
    n_reads rows: ([2 * n_reads, L] int32, [2 * n_reads] lengths).  Reads are
    right-aligned, so each reversed read is re-right-aligned."""
    import numpy as np

    L = qc.shape[1]
    fwd = np.asarray(qc)[:n_reads].astype(np.int64)
    rc = np.full_like(fwd, -1)
    for b in range(n_reads):
        m = int(lens[b])
        r = fwd[b, L - m:]
        rc[b, L - m:] = comp[np.maximum(r[::-1], 0)]
        rc[b, L - m:][r[::-1] < 0] = -1
    inter = np.empty((2 * n_reads, L), dtype=np.int32)
    inter[0::2] = fwd
    inter[1::2] = rc
    return inter, np.repeat(np.asarray(lens)[:n_reads], 2)


def greedy_lines(names, mvals, mcnt, nseeds):
    """One output line per (read, strand) from host copies of the greedy
    engine's per-lane results (lanes interleaved fwd, rc)."""
    import numpy as np

    from rowbowt_tpu.index import marker_allele, marker_pos

    lines = []
    for b, name in enumerate(names):
        for strand, lane in (("+", 2 * b), ("-", 2 * b + 1)):
            got = []
            for s_ in range(mvals.shape[1]):
                k = min(int(mcnt[lane, s_]), mvals.shape[2])
                got += [int(v) for v in mvals[lane, s_, :k] if v >= 0]
            lines.append("".join(
                [f"{name} {strand} seeds={int(nseeds[lane])} markers: "]
                + [f"{int(marker_pos(np.int64(v)))}/"
                   f"{int(marker_allele(np.int64(v)))} " for v in got]))
    return lines


if __name__ == "__main__":
    sys.exit(main())
