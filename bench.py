"""Standard benchmark: batched query throughput on one NVIDIA GPU, two configs.

Config "small" (BASELINE.md configs 1-3): 1 Mbp ref + 7 haplotypes (n=8.0M) —
count (headline), locate, windowed markers, and the production greedy-seeding
marker path (rb_markers' workload, /root/reference/src/rb_markers.cpp:550-595),
vs the single-thread native CPU baseline doing equivalent work
(native/cpu_engine.cpp; the reference binary itself is unbuildable here —
empty sdsl/pfbwt submodules).

Config "chr" (BASELINE.md config 4): 20 Mbp ref + 7 haplotypes (n=160M), the
chr21-scale regime where a full positional occ table cannot exist — the
fused-block rank path (one 96B row gather + SWAR popcount per rank) carries
every query.  Construction wall time and peak RSS are recorded at build time.

Every config runs once, in a worker process of its own that requires a GPU
(rowbowt_tpu.runtime); each result records the device it ran on.  Prints ONE
JSON line: {"metric", "value", "unit", "vs_baseline", ...extras}; exits
non-zero when a config it attempted failed.
"""

import json
import os
import resource
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

CFG = {
    "small": dict(cache=os.path.join(REPO, ".cache", "bench_idx"),
                  ref_len=1_000_000, n_haps=7, n_vars=3_000, seed=1234),
    "chr": dict(cache=os.path.join(REPO, ".cache", "bench_idx_chr"),
                ref_len=20_000_000, n_haps=7, n_vars=60_000, seed=4321),
}
BIG_CACHE = os.path.join(REPO, ".cache", "bench_idx_big")
GIANT_CACHE = os.path.join(REPO, ".cache", "bench_idx_giant")
N_READS = 262_144
READ_LEN = 100
# the count metric scans 4 batches of 65k lanes in one dispatch; secondary
# metrics use 2 of these batches concatenated (131k lanes)
BATCH = 65_536


def _ensure_native():
    lib = os.path.join(REPO, "native", "librbt_native.so")
    if not os.path.exists(lib):
        subprocess.run(["make", "-C", os.path.join(REPO, "native")], check=False,
                       capture_output=True)
    return os.path.exists(lib)


def _build_index(cfg):
    """Build + cache one synthetic pangenome index; records build stats."""
    from rowbowt_tpu.alphabet import SEP_BYTE, TERM_BYTE
    from rowbowt_tpu.construct.build import build_index
    from rowbowt_tpu.construct.panel import Marker
    from rowbowt_tpu.index import RbtIndex

    cache = cfg["cache"]
    rng = np.random.default_rng(cfg["seed"])
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=cfg["ref_len"])
    var_pos = np.sort(rng.choice(cfg["ref_len"], size=cfg["n_vars"], replace=False))
    var_alt = rng.choice(acgt, size=cfg["n_vars"])
    w = 10
    parts, doc_starts, markers = [], [], []
    pos = 0
    sep = np.full(w, SEP_BYTE, dtype=np.uint8)

    def add_doc(seq, sites):
        nonlocal pos
        doc_starts.append(pos)
        for p, allele in sites:
            markers.append(Marker(text_pos=pos + int(p), seq=0, pos=int(p), allele=allele))
        parts.append(seq)
        parts.append(sep)
        pos += len(seq) + w

    add_doc(ref, [(p, 0) for p in var_pos])
    for h in range(cfg["n_haps"]):
        hap = ref.copy()
        carry = rng.random(cfg["n_vars"]) < 0.5
        hap[var_pos[carry]] = var_alt[carry]
        add_doc(hap, [(p, 1 if c else 0) for p, c in zip(var_pos, carry)])
    parts.append(np.array([TERM_BYTE], dtype=np.uint8))
    text = np.concatenate(parts)
    print(f"building synthetic index: n={len(text):,} ...", file=sys.stderr)
    t0 = time.perf_counter()
    idx = build_index(text, markers=markers,
                      doc_starts=np.array(doc_starts, dtype=np.int64),
                      doc_names=["ref"] + [f"hap{h}" for h in range(cfg["n_haps"])],
                      ma_wsize=w, ftab_k=10)
    wall = time.perf_counter() - t0
    rss_gb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / (1 << 20)
    print(f"built in {wall:.1f}s (R={idx.R:,}, peak RSS {rss_gb:.1f} GB)",
          file=sys.stderr)
    os.makedirs(cache, exist_ok=True)
    idx.save(cache)
    np.save(os.path.join(cache, "text.npy"), text)
    with open(os.path.join(cache, "build_stats.json"), "w") as f:
        json.dump({"wall_s": round(wall, 1), "peak_rss_gb": round(rss_gb, 2),
                   "n": idx.n, "R": idx.R}, f)
    return RbtIndex.load(cache)


def _load_or_build(cfg):
    from rowbowt_tpu.index import RbtIndex

    meta = os.path.join(cfg["cache"], "rbt_meta.json")
    if os.path.exists(meta):
        with open(meta) as f:
            ver = json.load(f).get("version", 0)
        if ver >= 4:
            return RbtIndex.load(cfg["cache"])
        print("bench: stale index cache; rebuilding", file=sys.stderr)
    return _build_index(cfg)


def _sample_reads(cfg, rng, n_reads):
    text = np.load(os.path.join(cfg["cache"], "text.npy"), mmap_mode="r")
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    starts = rng.integers(0, len(text) - READ_LEN - 1, size=n_reads)
    reads = np.empty((n_reads, READ_LEN), dtype=np.uint8)
    for i, s in enumerate(starts):
        reads[i] = text[s:s + READ_LEN]
    bad = ~np.isin(reads, acgt).all(axis=1)
    for i in np.flatnonzero(bad):
        while True:
            s = int(rng.integers(0, len(text) - READ_LEN - 1))
            r = text[s:s + READ_LEN]
            if np.isin(r, acgt).all():
                reads[i] = r
                break
    mut = rng.random(n_reads) < 0.2
    mpos = rng.integers(0, READ_LEN, size=n_reads)
    mchar = rng.choice(acgt, size=n_reads)
    reads[np.arange(n_reads)[mut], mpos[mut]] = mchar[mut]
    return reads


def _cpu_big_view(idx):
    """BigIndex-shaped fb2 view of an RbtIndex for the CPU workload baselines
    (native/cpu_engine.cpp works over the two-level tables at every scale).
    The phi breakpoint table comes straight from the dense phi1."""
    from rowbowt_tpu.bigindex import BigIndex

    run_len = np.diff(np.append(np.asarray(idx.run_start), idx.n))
    codes = np.repeat(np.asarray(idx.run_head).astype(np.uint8), run_len)
    big = BigIndex.from_codes(codes, idx.alpha)
    del codes
    big.run_start = np.asarray(idx.run_start)
    big.run_head = np.asarray(idx.run_head).astype(np.uint8)
    big.samples_last = np.asarray(idx.samples_last)
    phi1 = np.asarray(idx.phi1).astype(np.int64)
    bp = np.flatnonzero(np.diff(phi1) != 1) + 1
    if bp.size == 0 or bp[0] != 0:
        bp = np.concatenate(([0], bp))
    big.pred_pos = bp
    big.phi_at = phi1[bp]
    R = idx.R
    keys = (np.asarray(idx.run_head).astype(np.int64) * R
            + np.arange(R, dtype=np.int64))
    big.cruns_keys = keys[np.argsort(np.asarray(idx.run_head), kind="stable")]
    big.ma_row = np.asarray(idx.ma_row)
    big.ma_val = np.asarray(idx.ma_val)
    return big


def _cpu_workloads(big, out, name, qcodes, rc_codes, lens, ncpu):
    """Single-thread CPU locate/markers/greedy baselines (every workload
    gets a vs_CPU multiple, not just count).  Records
    cpu_*_reads_per_s and the *_vs_baseline ratios against the device
    numbers already in `out`.

    Honesty rule: each measured call runs FRESH reads.  Re-timing the same
    read set lets the CPU keep the touched rank rows L3-resident (~13 MB
    per 1k reads), inflating its rate ~2x on the out-of-cache configs —
    the production workload streams new reads."""
    from rowbowt_tpu import cpu_backend

    def slice_of(i):
        a = (i * ncpu) % max(qcodes.shape[0] - ncpu, 1)
        return (qcodes[a:a + ncpu].astype(np.int16),
                lens[a:a + ncpu].astype(np.int32))

    q0, ln0 = slice_of(0)
    qr = rc_codes[:ncpu].astype(np.int16)
    # pre-cast every table OUTSIDE the timed region (the O(R)/O(M) int64
    # casts stream GBs off the mmap on first use) with tiny calls
    cpu_backend.locate_fb2(big, q0[:8], ln0[:8], max_hits=4)
    cpu_backend.markers_fb2(big, q0[:8], ln0[:8], wsize=10, max_range=1000)
    cpu_backend.greedy_fb2(big, q0[:8], ln0[:8], 10, 1000)

    def timed(fn, slices):
        t0 = time.perf_counter()
        for i in slices:
            qi, li = slice_of(i)
            fn(qi, li)
        return len(slices) * ncpu / (time.perf_counter() - t0)

    rl = timed(lambda qi, li: cpu_backend.locate_fb2(big, qi, li,
                                                     max_hits=4), (1, 2))
    out[f"cpu_locate_reads_per_s_{name}"] = round(rl, 1)
    rm = timed(lambda qi, li: cpu_backend.markers_fb2(
        big, qi, li, wsize=10, max_range=1000), (3, 4))
    out[f"cpu_markers_reads_per_s_{name}"] = round(rm, 1)
    t0 = time.perf_counter()
    cpu_backend.greedy_fb2(big, slice_of(5)[0], slice_of(5)[1], 10, 1000)
    cpu_backend.greedy_fb2(big, qr, ln0, 10, 1000)
    rg = ncpu / (time.perf_counter() - t0)
    out[f"cpu_greedy_reads_per_s_{name}"] = round(rg, 1)
    for dev_key, cpu_key, ratio_key in (
            (f"locate_reads_per_s_{name}", f"cpu_locate_reads_per_s_{name}",
             f"locate_vs_baseline_{name}"),
            (f"markers_reads_per_s_{name}", f"cpu_markers_reads_per_s_{name}",
             f"markers_vs_baseline_{name}"),
            (f"markers_greedy_reads_per_s_{name}",
             f"cpu_greedy_reads_per_s_{name}", f"greedy_vs_baseline_{name}")):
        if out.get(dev_key) and out.get(cpu_key):
            out[ratio_key] = round(out[dev_key] / out[cpu_key], 3)
    print(f"bench[{name}]: cpu-1t locate {rl:,.0f} markers "
          f"{rm:,.0f} greedy {rg:,.0f} reads/s", file=sys.stderr)


def _timeit(fn, *a, reps=3):
    """min-of-reps wall time of a warm call, synced with block_until_ready."""
    import jax

    jax.block_until_ready(fn(*a))
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*a))
        best = min(best, time.perf_counter() - t0)
    return best


def _device_record() -> dict:
    """The device a worker ran on, as JAX and nvidia-smi report it."""
    import jax

    from rowbowt_tpu import runtime

    d = jax.devices()[0]
    return {"platform": d.platform, "device_kind": d.device_kind,
            "device_count": len(jax.devices()),
            "nvidia_smi": runtime.nvidia_smi()}


def run_config(name: str) -> dict:
    import jax
    import jax.numpy as jnp

    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.device import DeviceIndex

    cfg = CFG[name]
    have_native = _ensure_native()
    idx = _load_or_build(cfg)
    out = {}
    if os.path.exists(os.path.join(cfg["cache"], "build_stats.json")):
        with open(os.path.join(cfg["cache"], "build_stats.json")) as f:
            bs = json.load(f)
        out[f"build_wall_s_{name}"] = bs["wall_s"]
        out[f"build_peak_rss_gb_{name}"] = bs["peak_rss_gb"]
    print(f"bench[{name}]: index n={idx.n:,} R={idx.R:,} "
          f"(fblock={'yes' if idx.fblock is not None else 'no'})", file=sys.stderr)
    rng = np.random.default_rng(99)
    reads = _sample_reads(cfg, rng, N_READS)
    tab = idx.alpha.encode_table()
    qcodes = tab[reads.astype(np.int64)].astype(np.int32)
    lengths = np.full(N_READS, READ_LEN, dtype=np.int32)

    dx = DeviceIndex.from_index(idx)
    if idx.kval is not None and idx.fblock is not None:
        dx = dx.lean()  # drop run-space tables: ~1 GB HBM at chr scale
    dev = jax.devices()[0]
    print(f"bench[{name}]: device {dev}", file=sys.stderr)

    # ---- count: one dispatch scanning all batches (headline) ----
    nb = N_READS // BATCH
    qc3 = jnp.asarray(qcodes[: nb * BATCH].reshape(nb, BATCH, READ_LEN))
    len2 = jnp.asarray(lengths[: nb * BATCH].reshape(nb, BATCH))

    @jax.jit
    def count_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            return None, find_ranges(dx, qc, ln)
        _, (lo, hi) = jax.lax.scan(step, None, (qc3, len2 + salt - salt))
        return lo, hi, jnp.sum(lo) + jnp.sum(hi)

    n_done = nb * BATCH
    res = jax.block_until_ready(count_all(dx, qc3, len2, 0))
    slo = np.asarray(res[0]).reshape(-1)
    best = _timeit(lambda s: count_all(dx, qc3, len2, s)[2], 1)
    rps = n_done / best
    out[f"count_reads_per_s_{name}"] = round(rps, 1)
    out[f"lf_steps_per_s_{name}"] = round(rps * READ_LEN, 0)
    print(f"bench[{name}]: count {rps:,.0f} reads/s "
          f"({rps*READ_LEN/1e6:,.0f} M LF-steps/s)", file=sys.stderr)
    _emit(out)

    # ---- CPU baseline (single thread, native, same work; FRESH reads per
    # timed call — re-timing one read set lets the CPU keep its touched
    # rank rows cache-resident, which the streaming workload never does) ----
    if have_native:
        from rowbowt_tpu.cpu_backend import count_ranges

        ncpu = 4096 if name == "small" else 1024
        clo, chi = count_ranges(idx, qcodes[:ncpu], lengths[:ncpu])  # warmup
        t0 = time.perf_counter()
        count_ranges(idx, qcodes[ncpu:2 * ncpu], lengths[ncpu:2 * ncpu])
        cpu_rps = ncpu / (time.perf_counter() - t0)
        print(f"bench[{name}]: cpu-1t {cpu_rps:,.0f} reads/s", file=sys.stderr)
        assert (slo[:ncpu] == clo[:ncpu]).all(), "accel != cpu baseline"
        out[f"vs_baseline_{name}"] = round(rps / cpu_rps, 3)
        _emit(out)

    # ---- locate (toehold + phi walk) ----
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate

    frt_jit = jax.jit(find_ranges_w_toehold)  # shared; avoid per-site re-jit

    # secondary metrics run one 131k-lane batch (2 count-batches concatenated)
    qb = jnp.concatenate([qc3[0], qc3[1]])
    lb = jnp.concatenate([len2[0], len2[1]])
    SB = 2 * BATCH

    @jax.jit
    def loc_all(dx, qc, ln, salt):
        lo, hi, k = find_ranges_w_toehold(dx, qc, ln + salt - salt)
        locs, cnt = locate(dx, lo, hi, k, max_hits=4)
        return jnp.sum(cnt) + jnp.sum(locs)

    tl = _timeit(lambda s: loc_all(dx, qb, lb, s), 1)
    out[f"locate_reads_per_s_{name}"] = round(SB / tl, 1)
    print(f"bench[{name}]: locate {SB/tl:,.0f} reads/s", file=sys.stderr)
    _emit(out)

    # ---- windowed markers (rb_align -m workload) ----
    from rowbowt_tpu.engine.markers import find_ranges_w_markers

    @jax.jit
    def mk_all(dx, qc, ln, salt):
        lo, hi, buf, used, ovf = find_ranges_w_markers(
            dx, qc, ln + salt - salt, wsize=10, max_range=1000, max_k=16)
        return jnp.sum(used) + jnp.sum(lo)

    tm = _timeit(lambda s: mk_all(dx, qb, lb, s), 1)
    out[f"markers_reads_per_s_{name}"] = round(SB / tm, 1)
    print(f"bench[{name}]: markers {SB/tm:,.0f} reads/s", file=sys.stderr)
    _emit(out)

    # ---- production greedy-seeding marker path (rb_markers workload:
    #      fwd + revcomp strands per read, rb_markers.cpp:396-400) ----
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding

    comp = np.full(16, -1, dtype=np.int32)
    for x, y in zip(b"ACGT", b"TGCA"):
        cx = int(tab[x])
        cy = int(tab[y])
        if cx >= 0 and cy >= 0:
            comp[cx] = cy
    rc = jnp.asarray(comp)[jnp.maximum(qb, 0)][:, ::-1]
    rc = jnp.where(qb[:, ::-1] >= 0, rc, -1)

    @jax.jit
    def greedy_all(dx, qf, qr, ln, salt):
        # use_ftab=False is the reference rb_markers DEFAULT (-f is opt-in,
        # rb_markers.cpp:56-134); the ftab-restart variant re-gathers a [B, k]
        # window every step and is benched separately below
        o = jnp.zeros((), dtype=jnp.int64)
        for q in (qf, qr):
            slo, shi, sqs, sqe, mvals, mcnt, ns = markers_greedy_seeding(
                dx, q, ln + salt - salt, wsize=10, max_range=1000,
                max_seeds=8, max_k=16, use_ftab=False)
            o = o + jnp.sum(mcnt.astype(jnp.int64)) + jnp.sum(ns.astype(jnp.int64))
        return o

    tg = _timeit(lambda s: greedy_all(dx, qb, rc, lb, s), 1)
    out[f"markers_greedy_reads_per_s_{name}"] = round(SB / tg, 1)
    print(f"bench[{name}]: greedy markers (both strands) {SB/tg:,.0f} reads/s",
          file=sys.stderr)
    _emit(out)

    if name == "chr":
        # config-4 proper: LONG reads (2 kb, 1% errors) greedy-seeded against
        # the chr-scale index (BASELINE.md config 4 / tests/greedy_seeding).
        # Runs BEFORE the unbounded-locate section and emits immediately, so
        # a cut in a later section keeps it.
        LB, LL = 8192, 2000
        text = np.load(os.path.join(cfg["cache"], "text.npy"), mmap_mode="r")
        acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
        lstarts = rng.integers(0, len(text) - LL - 1, size=LB)
        lreads = np.empty((LB, LL), dtype=np.uint8)
        for i, s in enumerate(lstarts):
            lreads[i] = text[s:s + LL]
        bad = ~np.isin(lreads, acgt).all(axis=1)
        lreads[bad] = lreads[np.flatnonzero(~bad)[0] if (~bad).any() else 0]
        nerr = LL // 100
        epos = rng.integers(0, LL, size=(LB, nerr))
        echr = rng.choice(acgt, size=(LB, nerr))
        lreads[np.arange(LB)[:, None], epos] = echr
        lq = jnp.asarray(tab[lreads.astype(np.int64)].astype(np.int32))
        ll = jnp.full(LB, LL, dtype=jnp.int32)

        @jax.jit
        def greedy_long(dx, q, ln, salt):
            o = markers_greedy_seeding(
                dx, q, ln + salt - salt, wsize=10, max_range=1000,
                max_seeds=32, max_k=16, use_ftab=False)
            return jnp.sum(o[5].astype(jnp.int64)) + jnp.sum(o[6].astype(jnp.int64))

        tl2 = _timeit(lambda s: greedy_long(dx, lq, ll, s), 1)
        out["greedy_long_reads_per_s_chr"] = round(LB / tl2, 1)
        print(f"bench[chr]: greedy LONG reads (2 kb) {LB/tl2:,.0f} reads/s "
              f"({LB*LL/tl2/1e6:,.1f} M chars/s)", file=sys.stderr)
        _emit(out)

        # ---- UNBOUNDED locate (rb_align -s contract: stream every occurrence,
        # toehold_sa.hpp:37-49) through the ragged bucketed walk.  Mixed range
        # sizes on purpose: mostly 100 bp reads (~8 hits each) plus truncated
        # 8 bp / 6 bp lanes whose ranges run 10^3-10^4+ occurrences — the
        # regime where per-bucket jit specializations + host round-trips could
        # bite.
        from rowbowt_tpu.engine.locate import locate_ragged

        UB = 8192
        ulens = np.full(UB, READ_LEN, dtype=np.int32)
        ulens[:32] = 8     # ~n/4^8  ~ 2.4k hits/lane
        ulens[32:48] = 6   # ~n/4^6  ~ 39k hits/lane
        uq = jnp.asarray(qcodes[:UB])
        ul = jnp.asarray(ulens)
        ulo, uhi, uk = frt_jit(dx, uq, ul)
        ulo, uhi, uk = np.asarray(ulo), np.asarray(uhi), np.asarray(uk)
        flat, offs = locate_ragged(dx, ulo, uhi, uk)  # warm bucket jits
        tu = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            flat, offs = locate_ragged(dx, ulo, uhi, uk)
            tu = min(tu, time.perf_counter() - t0)
        hits = int(offs[-1])
        out["locate_unbounded_reads_per_s_chr"] = round(UB / tu, 1)
        out["locate_unbounded_hits_per_s_chr"] = round(hits / tu, 0)
        print(f"bench[chr]: UNBOUNDED locate {UB/tu:,.0f} reads/s "
              f"({hits:,} occs, {hits/tu/1e6:,.2f} M occs/s)", file=sys.stderr)
        _emit(out)

    # ---- CPU baselines for every workload (after all device metrics so a
    # budget cut here costs nothing measured above) ----
    if have_native and idx.phi1 is not None:
        t0 = time.perf_counter()
        bigv = _cpu_big_view(idx)
        print(f"bench[{name}]: cpu fb2 view built in "
              f"{time.perf_counter() - t0:.1f}s", file=sys.stderr)
        _cpu_workloads(bigv, out, name, qcodes, np.asarray(rc), lengths,
                       4096 if name == "small" else 1024)
        _emit(out)
    return out


def run_big() -> dict:
    """Count throughput on the n > 2^31 index (int64 lanes, two-level fblock
    rank — rowbowt_tpu/bigindex.py).  The index is prebuilt by
    scripts/build_big_index.py (construction is far too slow for bench time);
    this worker only loads, transfers, and queries."""
    import jax
    import jax.numpy as jnp

    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.engine.count import find_ranges

    big = BigIndex.load(BIG_CACHE)
    out = {"n_big": big.n}
    bs_path = os.path.join(BIG_CACHE, "build_stats.json")
    if os.path.exists(bs_path):
        with open(bs_path) as f:
            bs = json.load(f)
        out["build_wall_s_big"] = bs.get("wall_s")
        out["build_peak_rss_gb_big"] = bs.get("peak_rss_gb")
    qcodes = np.load(os.path.join(BIG_CACHE, "qcodes.npy"))
    lens = np.load(os.path.join(BIG_CACHE, "qlens.npy"))
    if qcodes.shape[0] < 4 * BATCH:
        # the count scan runs 4 batches of 65k lanes (tools/big_scan_probe.py
        # compares batch counts) — tile the recorded reads up to that shape
        reps = -(-4 * BATCH // qcodes.shape[0])
        qcodes = np.tile(qcodes, (reps, 1))[: 4 * BATCH]
        lens = np.tile(lens, reps)[: 4 * BATCH]
    exp_lo = np.load(os.path.join(BIG_CACHE, "expect_lo.npy"))
    exp_hi = np.load(os.path.join(BIG_CACHE, "expect_hi.npy"))
    print(f"bench[big]: index n={big.n:,} (> 2^31: {big.n > (1 << 31)}), "
          f"fb2 {big.fb2.nbytes/2**30:.2f} GB", file=sys.stderr)
    t0 = time.perf_counter()
    dx = big.device_index()
    jax.block_until_ready(dx.arrays["fb2_64" if "fb2_64" in dx.arrays else "fb2"])
    out["hbm_load_s_big"] = round(time.perf_counter() - t0, 1)
    print(f"bench[big]: device {jax.devices()[0]}, HBM load "
          f"{out['hbm_load_s_big']}s", file=sys.stderr)

    nb = qcodes.shape[0] // BATCH
    qc3 = jnp.asarray(qcodes[: nb * BATCH].reshape(nb, BATCH, READ_LEN)
                      .astype(np.int32))
    len2 = jnp.asarray(lens[: nb * BATCH].reshape(nb, BATCH).astype(np.int32))

    @jax.jit
    def count_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            return None, find_ranges(dx, qc, ln)
        _, (lo, hi) = jax.lax.scan(step, None, (qc3, len2 + salt - salt))
        return lo, hi, jnp.sum(lo) + jnp.sum(hi)

    n_done = nb * BATCH
    res = jax.block_until_ready(count_all(dx, qc3, len2, 0))
    slo = np.asarray(res[0]).reshape(-1)
    shi = np.asarray(res[1]).reshape(-1)
    npar = exp_lo.shape[0]
    assert (slo[:npar] == exp_lo).all() and (shi[:npar] == exp_hi).all(), \
        "big-index device counts != prebuilt CPU parity record"
    print(f"bench[big]: parity ok on {npar} recorded reads", file=sys.stderr)
    best = _timeit(lambda s: count_all(dx, qc3, len2, s)[2], 1)
    rps = n_done / best
    out["count_reads_per_s_big"] = round(rps, 1)
    out["lf_steps_per_s_big"] = round(rps * READ_LEN, 0)
    print(f"bench[big]: count {rps:,.0f} reads/s "
          f"({rps*READ_LEN/1e6:,.0f} M LF-steps/s) at n={big.n:,}",
          file=sys.stderr)
    _emit(out)

    if _ensure_native():
        from rowbowt_tpu.cpu_backend import count_ranges_fb2

        # Pinned protocol (page-cache noise spreads single trials):
        # materialize the mmapped tables into RAM once OUTSIDE the timed
        # region (count_ranges_fb2's ascontiguousarray is then a no-op),
        # then median of 5 trials — each on a FRESH slice of the unique
        # recorded reads.  Re-timing one slice lets the CPU keep its ~13 MB
        # of touched rank rows L3-resident (cache warming, not the
        # streaming workload).
        big.fb2 = np.ascontiguousarray(np.asarray(big.fb2))
        ncpu = 1024
        clo, chi = count_ranges_fb2(big, qcodes[:ncpu], lens[:ncpu])
        trials = []
        for i in range(1, 6):
            a = i * ncpu
            t0 = time.perf_counter()
            count_ranges_fb2(big, qcodes[a:a + ncpu], lens[a:a + ncpu])
            trials.append(ncpu / (time.perf_counter() - t0))
        cpu_rps = float(np.median(trials))
        spread = (max(trials) - min(trials)) / cpu_rps
        assert (slo[:ncpu] == clo).all(), "big accel != cpu fb2 baseline"
        out["vs_baseline_big"] = round(rps / cpu_rps, 3)
        out["cpu_count_trials_big"] = [round(t, 0) for t in trials]
        out["cpu_count_spread_big"] = round(spread, 3)
        print(f"bench[big]: cpu-1t median {cpu_rps:,.0f} reads/s "
              f"(spread {spread:.1%}, x{rps/cpu_rps:,.1f})", file=sys.stderr)
    _emit(out)

    # ---- v2 artifact: toehold locate + markers at n > 2^31 (round 4) ----
    if not big.has_locate:
        print("bench[big]: count-only artifact (rebuild with "
              "scripts/build_big_index.py for locate/markers)", file=sys.stderr)
        return out
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate

    out["R_big"] = big.R
    exp_k = np.load(os.path.join(BIG_CACHE, "expect_k.npy"))
    exp_locs = np.load(os.path.join(BIG_CACHE, "expect_locs4.npy"))
    npar = exp_k.shape[0]

    @jax.jit
    def loc_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            lo, hi, k = find_ranges_w_toehold(dx, qc, ln + salt - salt)
            locs, cnt = locate(dx, lo, hi, k, max_hits=4)
            return None, (lo, hi, k, locs, cnt)
        _, r = jax.lax.scan(step, None, (qc3, len2))
        return r + (jnp.sum(r[4]) + jnp.sum(r[3]),)

    r = loc_all(dx, qc3, len2, 0)
    klo = np.asarray(r[0]).reshape(-1)[:npar]
    khi = np.asarray(r[1]).reshape(-1)[:npar]
    kk = np.asarray(r[2]).reshape(-1)[:npar]
    klocs = np.asarray(r[3]).reshape(-1, 4)[:npar]
    ne = exp_hi >= exp_lo
    assert (klo[ne] == exp_lo[ne]).all() and (khi[ne] == exp_hi[ne]).all()
    assert (kk[ne] == exp_k[ne]).all(), "big toehold != SA[hi] oracle"
    assert (klocs[ne] == exp_locs[ne]).all(), "big phi-walk locs != SA oracle"
    print(f"bench[big]: locate parity ok on {int(ne.sum())} reads "
          f"(toehold + 4-hit phi walk vs the merge-SA oracle)", file=sys.stderr)
    tl = _timeit(lambda s: loc_all(dx, qc3, len2, s)[5], 1)
    out["locate_reads_per_s_big"] = round(n_done / tl, 1)
    print(f"bench[big]: locate {n_done/tl:,.0f} reads/s (max_hits=4, "
          f"R={big.R:,})", file=sys.stderr)
    _emit(out)

    if not big.has_markers:
        return out
    from rowbowt_tpu.engine.markers import find_ranges_w_markers
    from rowbowt_tpu.ops import rank as RK

    # final-range marker parity vs the host CSR oracle
    exp_mcnt = np.load(os.path.join(BIG_CACHE, "expect_mcnt.npy"))
    exp_mvals = np.load(os.path.join(BIG_CACHE, "expect_mvals8.npy"))
    mv, mc = map(np.asarray, jax.jit(lambda d, lo, hi: RK.markers_at_range(
        d, lo, hi, 8))(dx, jnp.asarray(klo), jnp.asarray(khi)))
    assert (mc[ne] == exp_mcnt[ne]).all(), "big marker counts != CSR oracle"
    assert (mv[ne] == exp_mvals[ne]).all(), "big marker values != CSR oracle"
    print(f"bench[big]: marker parity ok on {int(ne.sum())} reads",
          file=sys.stderr)

    @jax.jit
    def mk_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            lo, hi, buf, used, ovf = find_ranges_w_markers(
                dx, qc, ln + salt - salt, wsize=10, max_range=1000, max_k=16)
            return None, jnp.sum(used) + jnp.sum(lo)
        _, s = jax.lax.scan(step, None, (qc3, len2))
        return jnp.sum(s)

    tm = _timeit(lambda s: mk_all(dx, qc3, len2, s), 1)
    out["markers_reads_per_s_big"] = round(n_done / tm, 1)
    print(f"bench[big]: markers {n_done/tm:,.0f} reads/s "
          f"(M={big.ma_row.shape[0]:,})", file=sys.stderr)
    _emit(out)

    # the production greedy-seeding genotyping path (rb_markers workload),
    # fwd+rc like the CLI: 2 lanes per read
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding

    # fwd+rc doubles the lanes: nb*2 batches of BATCH lanes, one scan
    rc3 = _revcomp_interleave(big.alpha, qcodes, lens, nb * 2)
    if rc3 is not None:
        g3, gl3 = rc3

        @jax.jit
        def greedy_all(dx, g3, gl3, salt):
            def step(_, xs):
                qc, ln = xs
                outs = markers_greedy_seeding(
                    dx, qc, ln + salt - salt, wsize=10, max_range=1000,
                    max_seeds=8, max_k=16, use_ftab=False, values=False)
                return None, outs[0].sum() + outs[5].sum()
            _, s = jax.lax.scan(step, None, (g3, gl3))
            return jnp.sum(s)

        n_reads_g = g3.shape[0] * g3.shape[1] // 2
        tg = _timeit(lambda s: greedy_all(dx, g3, gl3, s), 1)
        out["markers_greedy_reads_per_s_big"] = round(n_reads_g / tg, 1)
        print(f"bench[big]: greedy markers {n_reads_g/tg:,.0f} reads/s "
              f"(fwd+rc)", file=sys.stderr)
    _emit(out)

    # ---- UNBOUNDED locate (rb_align -s contract) at n > 2^31: the ragged
    # bucketed walk over the run-space breakpoint phi (each hop is a
    # searchsorted over the replicated O(R) table, not a dense phi1 gather)
    from rowbowt_tpu.engine.locate import locate_ragged

    UB = 4096
    ulens = np.full(UB, READ_LEN, dtype=np.int32)
    # substantial fan-out so the metric measures the PHI WALK, not the
    # per-bucket dispatch/readback floor: 64 lanes at ~2.3k hits + 64 at
    # ~140 hits + 3,968 full reads (~7 hits); tools/big_scan_probe.py
    # phi_probe measures the raw bitmap-phi hop rate.
    ulens[:64] = 10
    ulens[64:128] = 12
    uq = jnp.asarray(qcodes[:UB].astype(np.int32))
    ul = jnp.asarray(ulens)
    ulo2, uhi2, uk2 = map(np.asarray, find_ranges_w_toehold(dx, uq, ul))
    flat, offs = locate_ragged(dx, ulo2, uhi2, uk2)  # warm bucket jits
    tu = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        flat, offs = locate_ragged(dx, ulo2, uhi2, uk2)
        tu = min(tu, time.perf_counter() - t0)
    hits = int(offs[-1])
    out["locate_unbounded_reads_per_s_big"] = round(UB / tu, 1)
    out["locate_unbounded_hits_per_s_big"] = round(hits / tu, 0)
    print(f"bench[big]: UNBOUNDED locate {UB/tu:,.0f} reads/s "
          f"({hits:,} occs, {hits/tu/1e6:,.2f} M occs/s)", file=sys.stderr)
    _emit(out)

    # ---- CPU baselines for locate/markers/greedy at n > 2^31 ----
    if _ensure_native():
        tabb = big.alpha.encode_table()
        comp = np.full(16, -1, dtype=np.int64)
        for x, y in zip(b"ACGT", b"TGCA"):
            cx, cy = int(tabb[x]), int(tabb[y])
            if cx >= 0 and cy >= 0:
                comp[cx] = cy
        fwd = qcodes[:512].astype(np.int64)
        rcq = np.where(fwd[:, ::-1] >= 0, comp[np.maximum(fwd[:, ::-1], 0)],
                       -1)
        _cpu_workloads(big, out, "big", qcodes, rcq, lens, 512)
    _emit(out)
    return out


def run_giant() -> dict:
    """The n = 10^10 / 513-document PFP-built artifact (BASELINE config 5
    scale on one chip): count, toehold locate, markers, greedy genotyping,
    unbounded locate — every capability, one worker, one ~9.3 GB device set
    (fb2_256 + bitmap-phi locate tables + marker CSR).  Parity is the ANALYTIC carry-matrix oracle recorded
    by scripts/build_giant_index.py — independent of the construction."""
    import jax
    import jax.numpy as jnp

    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.engine.locate import (find_ranges_w_toehold, locate,
                                           locate_ragged)
    from rowbowt_tpu.engine.markers import find_ranges_w_markers
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding
    from rowbowt_tpu.ops import rank as RK

    big = BigIndex.load(GIANT_CACHE)
    out = {"n_giant": big.n, "R_giant": big.R}
    bs_path = os.path.join(GIANT_CACHE, "build_stats.json")
    if os.path.exists(bs_path):
        with open(bs_path) as f:
            bs = json.load(f)
        out["build_wall_s_giant"] = bs.get("wall_s")
        out["build_peak_rss_gb_giant"] = bs.get("peak_rss_gb")
    ld = lambda k: np.load(os.path.join(GIANT_CACHE, k))  # noqa: E731
    qcodes = ld("qcodes.npy")
    lens = ld("qlens.npy")
    exp_lo, exp_hi, exp_cnt = ld("expect_lo.npy"), ld("expect_hi.npy"), \
        ld("expect_cnt.npy")
    pos_flat, pos_off = ld("expect_pos_flat.npy"), ld("expect_pos_off.npy")
    mval_flat, mval_off = ld("expect_mval_flat.npy"), ld("expect_mval_off.npy")
    npar = exp_lo.shape[0]
    print(f"bench[giant]: n={big.n:,} R={big.R:,} "
          f"M={big.ma_row.shape[0]:,} (PFP-built, "
          f"{out.get('build_wall_s_giant')}s)", file=sys.stderr)
    t0 = time.perf_counter()
    dx = big.device_index()
    jax.block_until_ready(dx.arrays["fb2_256"])
    out["hbm_load_s_giant"] = round(time.perf_counter() - t0, 1)
    print(f"bench[giant]: device {jax.devices()[0]}, HBM load "
          f"{out['hbm_load_s_giant']}s", file=sys.stderr)

    nb = qcodes.shape[0] // BATCH
    qc3 = jnp.asarray(qcodes[: nb * BATCH].reshape(nb, BATCH, READ_LEN)
                      .astype(np.int32))
    len2 = jnp.asarray(lens[: nb * BATCH].reshape(nb, BATCH).astype(np.int32))

    @jax.jit
    def count_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            return None, find_ranges(dx, qc, ln)
        _, (lo, hi) = jax.lax.scan(step, None, (qc3, len2 + salt - salt))
        return lo, hi, jnp.sum(lo) + jnp.sum(hi)

    n_done = nb * BATCH
    res = jax.block_until_ready(count_all(dx, qc3, len2, 0))
    slo = np.asarray(res[0]).reshape(-1)
    shi = np.asarray(res[1]).reshape(-1)
    assert (slo[:npar] == exp_lo).all() and (shi[:npar] == exp_hi).all()
    assert ((shi[:npar] - slo[:npar] + 1) == exp_cnt).all(), \
        "device counts != carry-matrix analytic oracle"
    print(f"bench[giant]: count parity ok on {npar} reads "
          f"(analytic carry-matrix oracle)", file=sys.stderr)
    best = _timeit(lambda s: count_all(dx, qc3, len2, s)[2], 1)
    rps = n_done / best
    out["count_reads_per_s_giant"] = round(rps, 1)
    out["lf_steps_per_s_giant"] = round(rps * READ_LEN, 0)
    print(f"bench[giant]: count {rps:,.0f} reads/s "
          f"({rps*READ_LEN/1e6:,.0f} M LF-steps/s)", file=sys.stderr)
    _emit(out)

    if _ensure_native():
        from rowbowt_tpu.cpu_backend import count_ranges_fb2g

        big.fb2 = np.ascontiguousarray(np.asarray(big.fb2))
        # warmup (lazy zero-page faults on the 5.8 GB copy) + 5 trials on
        # FRESH read slices (see run_big: same-slice re-timing measures L3
        # residency, not the streaming workload)
        ncpu = 2048
        clo, chi = count_ranges_fb2g(big, qcodes[:ncpu], lens[:ncpu])
        trials = []
        for i in range(1, 6):
            a = i * ncpu
            t0 = time.perf_counter()
            count_ranges_fb2g(big, qcodes[a:a + ncpu], lens[a:a + ncpu])
            trials.append(ncpu / (time.perf_counter() - t0))
        cpu_rps = float(np.median(trials))
        assert (slo[:ncpu] == clo).all()
        out["vs_baseline_giant"] = round(rps / cpu_rps, 3)
        out["cpu_count_trials_giant"] = [round(t, 0) for t in trials]
        out["cpu_count_spread_giant"] = round(
            (max(trials) - min(trials)) / cpu_rps, 3)
        print(f"bench[giant]: cpu-1t median {cpu_rps:,.0f} reads/s "
              f"(spread {(max(trials)-min(trials))/cpu_rps:.1%}, "
              f"x{rps/cpu_rps:,.1f})", file=sys.stderr)
    _emit(out)

    # ---- toehold locate (max_hits=4): every loc must be a true occurrence
    @jax.jit
    def loc_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            lo, hi, k = find_ranges_w_toehold(dx, qc, ln + salt - salt)
            locs, cnt = locate(dx, lo, hi, k, max_hits=4)
            return None, (lo, hi, k, locs, cnt)
        _, r = jax.lax.scan(step, None, (qc3, len2))
        return r + (jnp.sum(r[4]) + jnp.sum(r[3]),)

    r = jax.block_until_ready(loc_all(dx, qc3, len2, 0))
    kk = np.asarray(r[2]).reshape(-1)[:npar]
    klocs = np.asarray(r[3]).reshape(-1, 4)[:npar]
    for b in range(npar):
        exp_set = set(pos_flat[pos_off[b]:pos_off[b + 1]].tolist())
        got = [int(x) for x in klocs[b] if x >= 0]
        assert int(kk[b]) in exp_set, (b, kk[b])
        assert len(set(got)) == len(got) and set(got) <= exp_set, (b, got)
    print(f"bench[giant]: locate parity ok on {npar} reads "
          f"(occurrence-set membership, analytic)", file=sys.stderr)
    tl = _timeit(lambda s: loc_all(dx, qc3, len2, s)[5], 1)
    out["locate_reads_per_s_giant"] = round(n_done / tl, 1)
    print(f"bench[giant]: locate {n_done/tl:,.0f} reads/s", file=sys.stderr)
    _emit(out)

    # ---- markers: analytic multiset parity on the final ranges
    mv, mc = map(np.asarray, jax.jit(
        lambda d, lo, hi: RK.markers_at_range(d, lo, hi, 8))(
        dx, jnp.asarray(exp_lo), jnp.asarray(exp_hi)))
    for b in range(npar):
        expv = mval_flat[mval_off[b]:mval_off[b + 1]]
        assert mc[b] == expv.shape[0], (b, mc[b], expv.shape[0])
        if mc[b] <= 8:
            got = np.sort(mv[b][mv[b] >= 0])
            assert np.array_equal(got, np.sort(expv)), b
    print(f"bench[giant]: marker parity ok on {npar} reads (analytic "
          f"multiset)", file=sys.stderr)

    @jax.jit
    def mk_all(dx, qc3, len2, salt):
        def step(_, xs):
            qc, ln = xs
            lo, hi, buf, used, ovf = find_ranges_w_markers(
                dx, qc, ln + salt - salt, wsize=10, max_range=1000, max_k=16)
            return None, jnp.sum(used) + jnp.sum(lo)
        _, s = jax.lax.scan(step, None, (qc3, len2))
        return jnp.sum(s)

    tm = _timeit(lambda s: mk_all(dx, qc3, len2, s), 1)
    out["markers_reads_per_s_giant"] = round(n_done / tm, 1)
    print(f"bench[giant]: markers {n_done/tm:,.0f} reads/s "
          f"(M={big.ma_row.shape[0]:,})", file=sys.stderr)
    _emit(out)

    # ---- greedy genotyping (fwd + rc)
    rc3 = _revcomp_interleave(big.alpha, qcodes, lens, nb * 2)
    if rc3 is not None:
        g3, gl3 = rc3

        @jax.jit
        def greedy_all(dx, g3, gl3, salt):
            def step(_, xs):
                qc, ln = xs
                outs = markers_greedy_seeding(
                    dx, qc, ln + salt - salt, wsize=10, max_range=1000,
                    max_seeds=8, max_k=16, use_ftab=False, values=False)
                return None, outs[0].sum() + outs[5].sum()
            _, s = jax.lax.scan(step, None, (g3, gl3))
            return jnp.sum(s)

        n_reads_g = g3.shape[0] * g3.shape[1] // 2
        tg = _timeit(lambda s: greedy_all(dx, g3, gl3, s), 1)
        out["markers_greedy_reads_per_s_giant"] = round(n_reads_g / tg, 1)
        print(f"bench[giant]: greedy markers {n_reads_g/tg:,.0f} reads/s "
              f"(fwd+rc)", file=sys.stderr)
    _emit(out)

    # ---- CPU baselines for locate/markers/greedy ----
    if _ensure_native():
        tabb = big.alpha.encode_table()
        comp = np.full(16, -1, dtype=np.int64)
        for x, y in zip(b"ACGT", b"TGCA"):
            cx, cy = int(tabb[x]), int(tabb[y])
            if cx >= 0 and cy >= 0:
                comp[cx] = cy
        fwd = qcodes[:512].astype(np.int64)
        rcq = np.where(fwd[:, ::-1] >= 0, comp[np.maximum(fwd[:, ::-1], 0)],
                       -1)
        _cpu_workloads(big, out, "giant", qcodes, rcq, lens, 512)
    _emit(out)

    # ---- UNBOUNDED locate: full occurrence-SET equality vs the analytic
    # oracle on the parity reads, then throughput on a mixed-width batch
    UB = 4096
    ulens = np.full(UB, READ_LEN, dtype=np.int32)
    ulens[:16] = 12
    uq = jnp.asarray(qcodes[:UB].astype(np.int32))
    ul = jnp.asarray(ulens)
    ulo2, uhi2, uk2 = map(np.asarray, find_ranges_w_toehold(dx, uq, ul))
    flat, offs = locate_ragged(dx, ulo2, uhi2, uk2)  # warm + parity
    for b in range(16, min(npar, 256)):  # full-length lanes only
        got = np.sort(flat[offs[b]:offs[b + 1]])
        expp = np.sort(pos_flat[pos_off[b]:pos_off[b + 1]])
        assert np.array_equal(got, expp), b
    print("bench[giant]: UNBOUNDED locate = exact analytic occurrence sets",
          file=sys.stderr)
    tu = float("inf")
    for _ in range(2):
        t0 = time.perf_counter()
        flat, offs = locate_ragged(dx, ulo2, uhi2, uk2)
        tu = min(tu, time.perf_counter() - t0)
    hits = int(offs[-1])
    out["locate_unbounded_reads_per_s_giant"] = round(UB / tu, 1)
    out["locate_unbounded_hits_per_s_giant"] = round(hits / tu, 0)
    print(f"bench[giant]: UNBOUNDED locate {UB/tu:,.0f} reads/s "
          f"({hits:,} occs, {hits/tu/1e6:,.2f} M occs/s)", file=sys.stderr)
    _emit(out)

    _emit(out)
    return out


def _revcomp_interleave(alpha, qcodes, lens, nb):
    """[N, L] codes -> [nb, B, L] with each read's fwd and rc interleaved as
    adjacent lanes (the rb_markers two-strand workload); None if too few."""
    import jax.numpy as jnp

    tab = alpha.encode_table()
    comp = np.full(16, -1, dtype=np.int64)
    for x, y in zip(b"ACGT", b"TGCA"):
        cx, cy = int(tab[x]), int(tab[y])
        if cx >= 0 and cy >= 0:
            comp[cx] = cy
    N, L = qcodes.shape
    half = nb * BATCH // 2
    if N < half:
        return None
    fwd = qcodes[:half].astype(np.int64)
    rc = np.where(fwd[:, ::-1] >= 0, comp[np.maximum(fwd[:, ::-1], 0)], -1)
    # reads here are full-length (right-aligned == left-aligned), so the
    # reversed read stays right-aligned
    inter = np.empty((half * 2, L), dtype=np.int32)
    inter[0::2] = fwd
    inter[1::2] = rc
    il = np.repeat(lens[:half], 2).astype(np.int32)
    return (jnp.asarray(inter.reshape(nb, BATCH, L)),
            jnp.asarray(il.reshape(nb, BATCH)))


def _emit(out: dict) -> None:
    """Cumulative partial result: the parent takes the LAST such line, so a
    hang in a later metric still delivers everything measured before it."""
    print("RESULT " + json.dumps(out))
    sys.stdout.flush()


def worker(name: str) -> int:
    from rowbowt_tpu import runtime

    runtime.init(allow_explicit_cpu=False)  # a measurement needs the GPU
    res = (run_big() if name == "big" else
           run_giant() if name == "giant" else run_config(name))
    res[f"device_{name}"] = _device_record()
    _emit(res)
    return 0


def _run_worker(name: str, timeout: float):
    """Run one config once in its own process (one JAX process on the card
    at a time); returns (its last RESULT record or None, ok)."""
    env = dict(os.environ, RBT_BENCH_WORKER=name)

    def last_result(stdout):
        if not stdout:
            return None
        if isinstance(stdout, bytes):
            stdout = stdout.decode(errors="replace")
        lines = [l for l in stdout.splitlines() if l.startswith("RESULT ")]
        return json.loads(lines[-1][len("RESULT "):]) if lines else None

    try:
        p = subprocess.run([sys.executable, "-u", os.path.abspath(__file__)],
                           env=env, timeout=timeout, capture_output=True,
                           text=True)
    except subprocess.TimeoutExpired as e:
        print(f"bench[{name}]: timeout ({timeout:.0f}s)", file=sys.stderr)
        if e.stderr:
            sys.stderr.write(e.stderr.decode(errors="replace")
                             if isinstance(e.stderr, bytes) else e.stderr)
        return last_result(e.stdout), False
    sys.stderr.write(p.stderr)
    got = last_result(p.stdout)
    if p.returncode != 0 or got is None:
        print(f"bench[{name}]: exit {p.returncode} "
              f"({'partial' if got else 'no'} result)", file=sys.stderr)
        return got, False
    return got, True


def _emit_final(acc: dict) -> None:
    """Print the COMPLETE headline JSON line with everything measured so far.

    Called after every config: if the driver's outer timeout kills a later
    config, the last stdout line is still a full parseable record."""
    headline = {
        "metric": "count_reads_per_s_chip",
        "value": acc.get("count_reads_per_s_small"),
        "unit": "reads/s",
        "vs_baseline": acc.get("vs_baseline_small"),
    }
    print(json.dumps({**headline, **acc}))
    sys.stdout.flush()


def main():
    # host-side index builds first, in a child that never touches the GPU.
    # The big (n > 2^31) and giant indexes are never built here; they are
    # built by scripts/build_big_index.py / build_giant_index.py and only
    # *loaded* if present.
    for name in ("small", "chr"):
        if not os.path.exists(os.path.join(CFG[name]["cache"], "rbt_meta.json")):
            subprocess.run([sys.executable, "-c",
                            f"import sys; sys.path.insert(0, {REPO!r}); "
                            f"import bench; bench._load_or_build(bench.CFG[{name!r}])"],
                           check=False)

    acc = {}
    failed = []
    runs = [("small", 900), ("chr", 1800)]
    if os.path.exists(os.path.join(BIG_CACHE, "meta.json")):
        runs.append(("big", 1200))
    if os.path.exists(os.path.join(GIANT_CACHE, "meta.json")):
        runs.append(("giant", 1200))
    for name, timeout in runs:
        got, ok = _run_worker(name, timeout)
        if got:
            acc.update(got)
        if not ok:
            failed.append(name)
        _emit_final(acc)
    if failed:
        print(f"bench: failed configs: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    w = os.environ.get("RBT_BENCH_WORKER")
    if w in CFG or w in ("big", "giant"):
        sys.exit(worker(w))
    else:
        sys.exit(main())
