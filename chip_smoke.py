"""Bring-up check: the r-index query engine end to end on NVIDIA GPUs.

    python chip_smoke.py              # one card: every phase below
    python chip_smoke.py --four-gpus  # four cards: the sharded paths only

One card, on a seeded chromosome-scale panel (20 Mbp reference, 4 diploid
samples, 60,000 SNVs: n ~ 180 M):

  1. native   build native/librbt_native.so (SA-IS, FASTQ reader, PFP fill);
  2. inputs   write panel.fa / panel.vcf / reads.fq (rowbowt_tpu.construct.synth);
  3. build    rbt_build --fasta --vcf -s -m -l;
  4. query    rbt_align -s -m (count, toehold locate, markers), then
              rbt_markers -w 10 (greedy seeding on both strands);
  5. parity   a seeded sample of reads against engine/naive.py: count ranges,
              locs, markers, greedy seeds with their markers — exact;
  6. layouts  the same BWT as the two-level fb2_64 and fb2_256 layouts:
              toehold ranges, locate and greedy seeding == the dense index;
  7. profile  rbt_markers --profile on a slice; a trace file must appear.

Four cards (--four-gpus), on the same panel and reads:
scripts/sharded_stream.py --greedy with the index position-sharded over 4
cards (--n-idx 4, psum per rank) and replicated over a 4-way data-parallel
mesh (--n-idx 1), each compared line for line with the single-card greedy
engine on the same reads.

Every phase runs through the entry points a user calls, on the card, compiled
by XLA; the CLIs run in this process (one JAX process per card).  Informational
lines come first; the last line is one JSON object,
{"ok": true, "device": {...}}, printed only when every phase passed.  Without
a GPU the script exits non-zero before any phase.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import glob
import io
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

from rowbowt_tpu import runtime

REPO = os.path.dirname(os.path.abspath(__file__))
WSIZE = 10
SAMPLES = 4            # diploid samples of the panel (8 haplotypes)
SITES_PER_KBP = 3      # SNV density: 60,000 sites on 20 Mbp
REF_LEN = 20_000_000   # reference bp: n ~ 180 M over 9 documents
N_READS = 65_536
READ_LEN = 100
PARITY_READS = 1024    # seeded sample checked against engine/naive.py
PROFILE_READS = 2048   # slice traced by rbt_markers --profile
MAX_RANGE = 1000       # rbt_markers -r default
MAX_SEEDS = 8          # rbt_markers --max-seeds default
MAX_MARKERS = 32       # rbt_markers --max-markers default


class PhaseError(RuntimeError):
    pass


def log(msg: str) -> None:
    print(msg, flush=True)


@contextlib.contextmanager
def phase(name: str, timings: dict):
    t0 = time.perf_counter()
    log(f"[{name}] start")
    yield
    timings[name] = time.perf_counter() - t0
    log(f"[{name}] ok in {timings[name]:.1f} s")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------- phase 1

def build_native() -> str:
    """make -C native; fails loudly (zlib.h is checked first)."""
    cxx = os.environ.get("CXX", "g++")
    probe = subprocess.run([cxx, "-E", "-x", "c++", "-"],
                           input="#include <zlib.h>\n", capture_output=True,
                           text=True)
    check(probe.returncode == 0,
          f"zlib.h not found by {cxx} (native/fastq_reader.cpp needs it): "
          f"{probe.stderr.strip()[-400:]}")
    r = subprocess.run(["make", "-C", os.path.join(REPO, "native")],
                       capture_output=True, text=True)
    check(r.returncode == 0, f"make -C native failed:\n{r.stdout}{r.stderr}")
    lib = os.path.join(REPO, "native", "librbt_native.so")
    check(os.path.exists(lib), f"{lib} missing after make")
    return lib


# ---------------------------------------------------------------- CLIs

def run_cli(main, argv, out_path=None) -> str:
    """Run a CLI main in this process; stdout to out_path (or returned)."""
    buf = io.StringIO()
    with contextlib.ExitStack() as st:
        f = st.enter_context(open(out_path, "w")) if out_path else buf
        st.enter_context(contextlib.redirect_stdout(f))
        rc = main(argv)
    check(rc == 0, f"{getattr(main, '__module__', main)} {argv} exited {rc}")
    if out_path:
        with open(out_path) as f:
            return f.read()
    return buf.getvalue()


# ---------------------------------------------------------------- parsing

@dataclasses.dataclass
class AlignRecord:
    rng: tuple[int, int]
    count: int
    locs: list[tuple[int, str, int]]
    markers: list[tuple[int, int]]


def parse_align(text: str) -> dict[str, AlignRecord]:
    """rbt_align -s -m output -> {read name: AlignRecord}."""
    out: dict[str, AlignRecord] = {}
    lines = text.splitlines()
    check(len(lines) % 3 == 0, f"rbt_align -s -m printed {len(lines)} lines")
    for i in range(0, len(lines), 3):
        head, locs, mk = lines[i:i + 3]
        name, rest = head.split(" ", 1)
        s, e = rest[rest.index("(") + 1:rest.index(")")].split(",")
        cnt = int(rest.rsplit("count=", 1)[1])
        check(locs.startswith("\tlocs: ") and mk.startswith("\tmarkers: "),
              f"malformed rbt_align record for {name}")
        loc_list = []
        for tok in locs[len("\tlocs: "):].split():
            l, doc_off = tok.split("/", 1)
            doc, off = doc_off.rsplit(":", 1)
            loc_list.append((int(l), doc, int(off)))
        mk_body = mk[len("\tmarkers: "):]
        mk_list = [] if mk_body.startswith("no markers") else [
            tuple(int(x) for x in tok.split("/")) for tok in mk_body.split()]
        out[name] = AlignRecord((int(s), int(e)), cnt, loc_list, mk_list)
    return out


def parse_markers(text: str) -> dict[str, list[str]]:
    """rbt_markers output -> {read name: its seed lines, in order}."""
    out: dict[str, list[str]] = {}
    for line in text.splitlines():
        out.setdefault(line.split(" ", 1)[0], []).append(line)
    return out


# ---------------------------------------------------------------- naive side

def expected_align(idx, seq: bytes) -> AlignRecord:
    """What rbt_align -s -m must print for one read, from engine/naive.py."""
    from rowbowt_tpu.engine import naive
    from rowbowt_tpu.index import marker_allele, marker_pos

    codes = idx.alpha.encode(np.frombuffer(seq, np.uint8)).astype(np.int64)
    rn, k = naive.find_range_w_toehold(idx, codes)
    s, e = rn
    locs = [(l, *naive.resolve_offset(idx, l)) for l in
            naive.locate_range(idx, s, e, k, 1 << 62)]
    mk = [(int(marker_pos(m)), int(marker_allele(m)))
          for m in naive.markers_at_range(idx, s, e)]
    return AlignRecord((s, e), e - s + 1 if e >= s else 0, locs, mk)


def expected_markers(idx, name: str, seq: bytes, wsize=WSIZE,
                     max_range=MAX_RANGE, max_seeds=MAX_SEEDS,
                     max_k=MAX_MARKERS) -> list[str]:
    """rbt_markers' seed lines for one read: naive greedy seeding on both
    strands, then rb_markers' out_fn (rb_markers.cpp:365-382) written out
    here.  The CLI keeps the first --max-seeds seeds of a strand and the first
    --max-markers markers of a seed; out_fn drops a seed with an empty range,
    counts a '-' seed's start from the read's end, and sorts and dedups its
    markers.  Sizes wrap mod 2^64 like the reference's size_t."""
    from rowbowt_tpu.alphabet import normalize_read, revcomp
    from rowbowt_tpu.engine import naive
    from rowbowt_tpu.index import marker_allele, marker_pos, marker_seq

    s = normalize_read(seq)
    lines = []
    for strand, q in (("+", s), ("-", revcomp(s))):
        seeds = []
        naive.get_markers_greedy_seeding(
            idx, idx.alpha.encode(q).astype(np.int64), wsize, max_range,
            lambda rn, qr, mk: seeds.append((rn, qr, list(mk))),
            use_ftab=False)
        for (lo, hi), (qs, qe), mk in seeds[:max_seeds]:
            lo, hi, qs, qe = int(lo), int(hi), int(qs), int(qe)
            if hi < lo:
                continue
            start = len(s) - qs - 1 if strand == "-" else qs
            fields = [name, str((hi - lo + 1) % (1 << 64)), strand, str(start),
                      str((qe - qs + 1) % (1 << 64))]
            mk = sorted({int(m) for m in mk[:max_k]})
            fields += [f"{marker_seq(m)}/{marker_pos(m)}/{marker_allele(m)}"
                       for m in mk] or ["."]
            lines.append(" ".join(fields))
    return lines


def check_parity(idx, reads, align_out: dict, markers_out: dict) -> dict:
    """Compare the CLI outputs for `reads` [(name, seq)] with the naive
    engine; returns per-kind match counts, raises on any mismatch."""
    res = {"reads": 0, "count": 0, "locate": 0, "markers": 0, "greedy": 0}
    bad = []
    for name, seq in reads:
        res["reads"] += 1
        got = align_out.get(name)
        want = expected_align(idx, seq)
        if got is None:
            bad.append(f"{name}: missing from rbt_align output")
            continue
        for kind, field in (("count", "rng"), ("locate", "locs"),
                            ("markers", "markers")):
            g, w = getattr(got, field), getattr(want, field)
            if kind == "count":
                g, w = (g, got.count), (w, want.count)
            if g == w:
                res[kind] += 1
            else:
                bad.append(f"{name} {kind}: got {g} want {w}")
        want_lines = expected_markers(idx, name, seq)
        if markers_out.get(name, []) == want_lines:
            res["greedy"] += 1
        else:
            bad.append(f"{name} greedy: got {markers_out.get(name, [])[:3]} "
                       f"want {want_lines[:3]}")
    check(not bad, f"{len(bad)} parity mismatches, first: {bad[:5]}")
    return res


# ---------------------------------------------------------------- phase 6

def two_level_indexes(idx, marker_tpos, marker_packed):
    """The dense index's BWT as BigIndex artifacts in the fb2 (128-symbol
    rows, repacked to fb2_64 on load) and fb2_256 (256-symbol rows) layouts,
    with the O(R) locate and O(M) marker tables."""
    import ctypes

    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.construct import pfp

    run_len = np.diff(np.append(idx.run_start, idx.n))
    codes = np.repeat(idx.run_head.astype(np.uint8), run_len)
    sa32 = np.asarray(idx.kval).astype(np.uint32)
    big = BigIndex.from_codes(codes, idx.alpha)
    big.attach_locate(codes, sa32)
    big.attach_markers(sa32, marker_tpos, marker_packed, idx.ma_wsize)
    del codes, sa32
    n_sup = big.n_sup
    nb = -(-idx.n // 256)
    per_blk = -(-nb // n_sup)
    fb256 = np.zeros((n_sup * per_blk, 40), dtype=np.int32)
    base256 = np.zeros((n_sup, 8), dtype=np.int64)
    heads = np.ascontiguousarray(idx.run_head.astype(np.uint8))
    lens = np.ascontiguousarray(run_len.astype(np.int64))
    pfp._lib().rbt_fb2_fill_rle(
        pfp._ptr(heads, ctypes.c_uint8), pfp._ptr(lens, ctypes.c_int64),
        heads.shape[0], idx.A, idx.n, 256, per_blk, n_sup,
        pfp._ptr(fb256, ctypes.c_int32), pfp._ptr(base256, ctypes.c_int64))
    big256 = dataclasses.replace(big, fb2=fb256, base=base256, per_blk=per_blk)
    return {"fb2_64": big, "fb2_256": big256}


def engine_outputs(dx, qc, lens, gq, gl) -> dict:
    """Toehold ranges, 8-hit locate and greedy seeding (both strands) for one
    DeviceIndex, as host arrays."""
    import jax

    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding

    lo, hi, k = find_ranges_w_toehold(dx, qc, lens)
    locs, nocc = locate(dx, lo, hi, k, max_hits=8)
    out = {"lo": lo, "hi": hi, "k": k, "locs": locs, "nocc": nocc}
    names = ("slo", "shi", "sqs", "sqe", "mvals", "mcnt", "nseeds")
    for strand, (q, ln) in enumerate(zip(gq, gl)):
        g = markers_greedy_seeding(dx, q, ln, wsize=WSIZE,
                                   max_range=MAX_RANGE, max_seeds=MAX_SEEDS,
                                   max_k=MAX_MARKERS, use_ftab=False)
        out.update({f"{nm}{strand}": v for nm, v in zip(names, g)})
    jax.block_until_ready(out)
    return {key: np.asarray(v) for key, v in out.items()}


def compare_outputs(ref: dict, got: dict, label: str) -> int:
    """Require every output array of `got` to equal the dense index's."""
    for key in ref:
        a, b = ref[key], got[key]
        if a.shape != b.shape:
            raise PhaseError(f"{label}: {key} shape {b.shape} != {a.shape}")
        check(np.array_equal(a, b), f"{label}: {key} differs from the dense "
              f"index in {int((a != b).sum())} entries")
    return len(ref)


def query_lanes(idx, seqs, L):
    """Raw reads as right-aligned code lanes, plus the normalized fwd and
    reverse-complement lanes of the greedy (rbt_markers) path."""
    from rowbowt_tpu.alphabet import normalize_read, revcomp
    from rowbowt_tpu.engine.batch import encode_batch

    qc, lens = encode_batch(idx, seqs, pad_to=L)
    norm = [normalize_read(s) for s in seqs]
    fq, fl = encode_batch(idx, [n.tobytes() for n in norm], pad_to=L)
    rq, rl = encode_batch(idx, [revcomp(n).tobytes() for n in norm], pad_to=L)
    return qc, lens, (fq, rq), (fl, rl)


def timed(fn, *a):
    """Wall seconds of a warm call, synced on the device."""
    import jax

    jax.block_until_ready(fn(*a))
    t0 = time.perf_counter()
    jax.block_until_ready(fn(*a))
    return time.perf_counter() - t0


# ---------------------------------------------------------------- runs

def write_inputs(work: str, seed: int, ref_len: int, n_reads: int):
    from rowbowt_tpu.construct import synth

    return synth.write_panel(os.path.join(work, "in"), seed=seed,
                             ref_len=ref_len, n_samples=SAMPLES,
                             n_sites=ref_len * SITES_PER_KBP // 1000,
                             n_reads=n_reads, read_len=READ_LEN)


def device_report() -> dict:
    import jax

    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def peak_bytes() -> list[int]:
    import jax

    return [int((d.memory_stats() or {}).get("peak_bytes_in_use", -1))
            for d in jax.local_devices()]


def run_single(work: str, seed: int, *, ref_len=REF_LEN, n_reads=N_READS,
               parity_reads=PARITY_READS, profile_reads=PROFILE_READS) -> None:
    import jax

    from rowbowt_tpu.cli import rbt_align, rbt_build, rbt_markers
    from rowbowt_tpu.construct import build_panel, synth
    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding
    from rowbowt_tpu.index import RbtIndex, pack_marker
    from rowbowt_tpu.io.fastq import read_seqs

    t = {}
    with phase("native", t):
        build_native()
    with phase("inputs", t):
        p = write_inputs(work, seed, ref_len, n_reads)
        log(f"  ref {p.ref_len:,} bp, {p.n_samples} samples "
            f"({2 * p.n_samples} haplotypes), {p.n_sites:,} SNVs, "
            f"{p.n_reads:,} reads of {READ_LEN} bp")
    idx_dir = os.path.join(work, "idx")
    with phase("build", t):
        run_cli(rbt_build.main, ["--fasta", p.fasta, "--vcf", p.vcf,
                                 "--wsize", str(WSIZE), "-s", "-m", "-l",
                                 "-o", idx_dir])
    idx = RbtIndex.load(idx_dir)
    log(f"  n = {idx.n:,}  R = {idx.R:,}  markers = {idx.ma_row.shape[0]:,}")
    with phase("query", t):
        t0 = time.perf_counter()
        align_txt = run_cli(rbt_align.main, [idx_dir, p.fastq, "-s", "-m"],
                            os.path.join(work, "align.txt"))
        t_align = time.perf_counter() - t0
        t0 = time.perf_counter()
        markers_txt = run_cli(rbt_markers.main,
                              [idx_dir, p.fastq, "-w", str(WSIZE)],
                              os.path.join(work, "markers.txt"))
        t_markers = time.perf_counter() - t0
        log(f"  rbt_align -s -m: {t_align:.1f} s wall incl. load+compile, "
            f"{p.n_reads / t_align:,.0f} reads/s (info)")
        log(f"  rbt_markers -w {WSIZE}: {t_markers:.1f} s wall incl. "
            f"load+compile, {p.n_reads / t_markers:,.0f} reads/s (info)")
    reads = [(nm, seq) for nm, seq, _ in read_seqs(p.fastq)]
    with phase("parity", t):
        rng = np.random.default_rng(seed + 1)
        pick = np.sort(rng.choice(len(reads), replace=False,
                                  size=min(parity_reads, len(reads))))
        res = check_parity(idx, [reads[i] for i in pick],
                           parse_align(align_txt), parse_markers(markers_txt))
        log("  naive parity: " + " ".join(f"{k}={v}" for k, v in res.items())
            + " (all exact)")
    del align_txt, markers_txt
    with phase("layouts", t):
        dx = DeviceIndex.from_index(idx)
        nbytes = sum(int(v.nbytes) for v in dx.arrays.values())
        log(f"  dense device tables: {nbytes / 2**30:.2f} GiB "
            f"({', '.join(sorted(dx.arrays))})")
        seqs = [s for _, s in reads]
        qc, lens, gq, gl = query_lanes(idx, seqs, 128)
        ref = engine_outputs(dx, qc, lens, gq, gl)
        panel = build_panel(p.fasta, p.vcf, wsize=WSIZE)
        tpos = [m.text_pos for m in panel.markers]
        packed = [pack_marker(m.seq, m.pos, m.allele) for m in panel.markers]
        del panel
        for label, big in two_level_indexes(idx, tpos, packed).items():
            bdx = big.device_index()
            check(label in bdx.arrays, f"{label} layout not selected")
            got = engine_outputs(bdx, qc, lens, gq, gl)
            n_arr = compare_outputs(ref, got, label)
            log(f"  {label}: {n_arr} output arrays over {len(seqs):,} reads "
                f"== dense (int64 lanes, CSR marker bounds)")
            del bdx, got
        # warm engine rates on the dense index (info; plain XLA loops over
        # device-resident lanes padded to 128 steps)
        B = qc.shape[0]
        qc, lens, fq, fl = jax.device_put((qc, lens, gq[0], gl[0]))
        tc = timed(find_ranges, dx, qc, lens)
        tl = timed(lambda: locate(dx, *find_ranges_w_toehold(dx, qc, lens),
                                  max_hits=8))
        tg = timed(lambda: markers_greedy_seeding(
            dx, fq, fl, wsize=WSIZE, max_range=MAX_RANGE,
            max_seeds=MAX_SEEDS, max_k=MAX_MARKERS, use_ftab=False))
        log(f"  warm dense engines, one {B:,}-lane batch: count "
            f"{B / tc:,.0f} reads/s ({B * READ_LEN / tc / 1e6:,.0f} M "
            f"LF steps/s); toehold+locate(8) {B / tl:,.0f} reads/s; greedy "
            f"one strand {B / tg:,.0f} lanes/s (info)")
        del dx
    with phase("profile", t):
        slice_fq = os.path.join(work, "slice.fq")
        synth.write_fastq(slice_fq, np.array(
            [np.frombuffer(s, np.uint8) for _, s in reads[:profile_reads]]))
        trace_dir = os.path.join(work, "trace")
        run_cli(rbt_markers.main, [idx_dir, slice_fq, "-w", str(WSIZE),
                                   "--profile", trace_dir])
        files = glob.glob(os.path.join(trace_dir, "**", "*.xplane.pb"),
                          recursive=True)
        check(bool(files), f"no .xplane.pb trace under {trace_dir}")
        size = sum(os.path.getsize(f) for f in files)
        log(f"  trace: {len(files)} file(s), {size:,} bytes; "
            f"device planes: {device_planes(files[0])}")
    log("  peak device memory (memory_stats): "
        + ", ".join(f"{b / 2**30:.2f} GiB" for b in peak_bytes()))
    log("  phase walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items()))


def device_planes(path: str) -> str:
    """Names of the trace's device planes and their event counts (info)."""
    try:
        from jax.profiler import ProfileData

        pd = ProfileData.from_file(path)
        out = []
        for plane in pd.planes:
            if "/device:" in plane.name:
                n = sum(1 for line in plane.lines for _ in line.events)
                out.append(f"{plane.name}={n} events")
        return "; ".join(out) or "none"
    except Exception as e:  # informational only
        return f"unreadable ({e})"


def run_four(work: str, seed: int, *, ref_len=REF_LEN,
             n_reads=N_READS) -> None:
    import importlib.util

    import jax

    from rowbowt_tpu.cli import rbt_build
    from rowbowt_tpu.cli.common import iter_query_batches
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding
    from rowbowt_tpu.index import RbtIndex

    n_dev = len(jax.devices())
    check(n_dev == 4, f"--four-gpus needs 4 devices, JAX sees {n_dev}")
    spec = importlib.util.spec_from_file_location(
        "sharded_stream", os.path.join(REPO, "scripts", "sharded_stream.py"))
    ss = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ss)

    t = {}
    with phase("native", t):
        build_native()
    with phase("inputs", t):
        p = write_inputs(work, seed, ref_len, n_reads)
    idx_dir = os.path.join(work, "idx")
    with phase("build", t):
        run_cli(rbt_build.main, ["--fasta", p.fasta, "--vcf", p.vcf,
                                 "--wsize", str(WSIZE), "-s", "-m", "-l",
                                 "-o", idx_dir])
    idx = RbtIndex.load(idx_dir, with_sa=False, with_dl=False)
    log(f"  n = {idx.n:,}  R = {idx.R:,}")
    bs = 4096
    with phase("single", t):
        dx = DeviceIndex.from_index(idx, device=jax.devices()[0])
        comp = ss.complement_codes(idx.alpha)
        want = []
        for names, qc, lens in iter_query_batches(idx, p.fastq, bs):
            inter, il = ss.revcomp_lanes(qc, lens, comp, len(names))
            g = markers_greedy_seeding(dx, jax.device_put(inter, jax.devices()[0]),
                                       jax.device_put(il.astype(np.int32),
                                                      jax.devices()[0]),
                                       wsize=WSIZE, max_range=MAX_RANGE,
                                       use_ftab=False)
            g = [np.asarray(x) for x in g]
            want += ss.greedy_lines(names, g[4], g[5], g[6])
        del dx
    for n_idx in (4, 1):
        label = f"n_idx{n_idx}"
        with phase(label, t):
            txt = run_cli(ss.main, [idx_dir, p.fastq, "--greedy", "--n-idx",
                                    str(n_idx), "-b", str(bs), "--wsize",
                                    str(WSIZE), "--max-range",
                                    str(MAX_RANGE)])
            got = txt.splitlines()
            diff = sum(a != b for a, b in zip(got, want))
            check(len(got) == len(want) and diff == 0,
                  f"{label}: {len(got)} lines vs {len(want)} single-card, "
                  f"{diff} differ")
            mesh = "idx=4 (position-sharded, psum per rank)" if n_idx == 4 \
                else "dp=4 (index replicated)"
            log(f"  sharded_stream --greedy --n-idx {n_idx} [{mesh}]: "
                f"{len(got):,} lines == single-card engine")
    log("  peak device memory (memory_stats): "
        + ", ".join(f"{b / 2**30:.2f} GiB" for b in peak_bytes()))
    log("  phase walls: " + ", ".join(f"{k} {v:.1f} s" for k, v in t.items()))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("--four-gpus", action="store_true",
                    help="run only the 4-card sharded/replicated path")
    ap.add_argument("--seed", type=int, default=21)
    ap.add_argument("--work", default=os.path.join(REPO, ".cache", "chip_smoke"),
                    help="scratch directory (removed at the end)")
    ap.add_argument("--keep", action="store_true",
                    help="keep the scratch directory")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        runtime.init(allow_explicit_cpu=False)
    except runtime.NoAcceleratorError as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 1
    t0 = time.perf_counter()
    try:
        for line in runtime.nvidia_smi():
            log(line)
        dev = device_report()
        log(f"  jax {dev}")
        shutil.rmtree(args.work, ignore_errors=True)
        os.makedirs(args.work)
        (run_four if args.four_gpus else run_single)(args.work, args.seed)
    except Exception as e:  # any failed phase: no ok line
        import traceback

        traceback.print_exc()
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        if not args.keep:
            shutil.rmtree(args.work, ignore_errors=True)
    log(f"  total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"ok": True, "device": dev}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
