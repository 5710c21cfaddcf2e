"""BigIndex (two-level fblock, int64 lanes): the n >= 2^31 count engine,
property-tested at toy scale against the replicated fblock engine and naive.
The at-scale proof (a real > 2^31 artifact) is built by
scripts/build_big_index.py and exercised by bench.py's "big" config."""

import numpy as np

from rowbowt_tpu.bigindex import BigIndex
from rowbowt_tpu.engine import naive
from rowbowt_tpu.engine.batch import encode_batch
from rowbowt_tpu.engine.count import find_ranges


def _codes_of(idx):
    run_len = np.diff(np.append(idx.run_start, idx.n))
    return np.repeat(idx.run_head.astype(np.uint8), run_len)


def test_bigindex_count_matches_naive(rand_index):
    idx, text = rand_index
    big = BigIndex.from_codes(_codes_of(idx), idx.alpha, n_sup=4)
    assert big.base.dtype == np.int64
    dx = big.device_index()
    assert dx.idx_dtype == np.int64
    rng = np.random.default_rng(11)
    reads = []
    for _ in range(24):
        L = int(rng.integers(3, 30))
        p = int(rng.integers(0, len(text) - L))
        reads.append(bytes(text[p:p + L]))
    qc, lens = encode_batch(idx, reads)
    lo, hi = find_ranges(dx, qc, lens)
    lo, hi = np.asarray(lo), np.asarray(hi)
    assert lo.dtype == np.int64
    # default is the 64B-row repack; the 96B layout must agree lane-exact
    assert "fb2_64" in dx.arrays
    dx96 = big.device_index(fb64=False)
    lo96, hi96 = map(np.asarray, find_ranges(dx96, qc, lens))
    assert (lo96 == lo).all() and (hi96 == hi).all()
    for b, r in enumerate(reads):
        codes = idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)
        assert (lo[b], hi[b]) == naive.find_range(idx, codes), (b, r)


def test_bigindex_cpu_baseline_matches(rand_index):
    """The native fb2 CPU count (bench baseline) == naive."""
    import pytest

    from rowbowt_tpu import cpu_backend

    if not cpu_backend.available():
        pytest.skip("no native lib")
    idx, text = rand_index
    big = BigIndex.from_codes(_codes_of(idx), idx.alpha, n_sup=4)
    rng = np.random.default_rng(15)
    reads = []
    for _ in range(24):
        L = int(rng.integers(3, 30))
        p = int(rng.integers(0, len(text) - L))
        reads.append(bytes(text[p:p + L]))
    qc, lens = encode_batch(idx, reads)
    lo, hi = cpu_backend.count_ranges_fb2(big, np.asarray(qc), np.asarray(lens))
    for b, r in enumerate(reads):
        codes = idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)
        assert (lo[b], hi[b]) == naive.find_range(idx, codes), (b, r)


def test_bigindex_save_load_roundtrip(tmp_path, rand_index):
    idx, text = rand_index
    big = BigIndex.from_codes(_codes_of(idx), idx.alpha, n_sup=3)
    big.save(str(tmp_path / "big"))
    back = BigIndex.load(str(tmp_path / "big"))
    assert (back.n, back.A, back.per_blk) == (big.n, big.A, big.per_blk)
    np.testing.assert_array_equal(np.asarray(back.fb2), big.fb2)
    np.testing.assert_array_equal(back.base, big.base)
    np.testing.assert_array_equal(back.F, big.F)


def test_bigindex_sharded_view_matches(rand_index):
    """One artifact, two engines: the sharded view must count identically."""
    import jax

    from rowbowt_tpu.parallel.mesh import make_mesh
    from rowbowt_tpu.parallel.sharded_dense import find_ranges_sharded_dense

    idx, text = rand_index
    big = BigIndex.from_codes(_codes_of(idx), idx.alpha, n_sup=4)
    sdx = big.sharded_index()
    mesh = make_mesh(n_dp=2, n_idx=4)
    tables = sdx.device_put(mesh)
    rng = np.random.default_rng(13)
    reads = []
    for _ in range(16):
        L = int(rng.integers(3, 25))
        p = int(rng.integers(0, len(text) - L))
        reads.append(bytes(text[p:p + L]))
    qc, lens = encode_batch(idx, reads)
    slo, shi = find_ranges_sharded_dense(mesh, sdx, tables, qc, lens)
    dlo, dhi = find_ranges(big.device_index(), qc, lens)
    np.testing.assert_array_equal(np.asarray(slo), np.asarray(dlo))
    np.testing.assert_array_equal(np.asarray(shi), np.asarray(dhi))


# ---------------------------------------------------------------------------
# v2: O(R) locate + O(M) marker tables (the n >= 2^31 capability, round 4)
# ---------------------------------------------------------------------------

def _marker_fixture():
    """Panel with markers, built whole-text so BigIndex rows match RbtIndex."""
    from rowbowt_tpu.alphabet import SEP_BYTE, TERM_BYTE
    from rowbowt_tpu.construct.build import build_index
    from rowbowt_tpu.construct.panel import Marker

    rng = np.random.default_rng(123)
    parts, doc_starts, markers = [], [], []
    pos, w = 0, 6
    for d in range(4):
        L = int(rng.integers(300, 500))
        seq = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=L)
        doc_starts.append(pos)
        for _ in range(8):
            p = int(rng.integers(0, L))
            markers.append(Marker(text_pos=pos + p, seq=0, pos=p,
                                  allele=int(rng.integers(0, 2))))
        parts.append(seq)
        parts.append(np.full(w, SEP_BYTE, dtype=np.uint8))
        pos += L + w
    parts.append(np.array([TERM_BYTE], dtype=np.uint8))
    text = np.concatenate(parts)
    idx = build_index(text, markers=markers,
                      doc_starts=np.array(doc_starts, dtype=np.int64),
                      doc_names=[f"doc{d}" for d in range(4)], ma_wsize=w)
    return idx, text, markers


def _reads_of(text, rng, k=40):
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for i in range(k):
        L = int(rng.integers(2, 40))
        p = int(rng.integers(0, len(text) - L))
        r = np.array(text[p:p + L])
        if i % 3 == 0 and L > 4:  # mutate: failing/short-seed lanes
            r[int(rng.integers(0, L))] = acgt[int(rng.integers(0, 4))]
        if np.isin(r, acgt).all():
            reads.append(bytes(r))
    return reads


def _big_v2(idx):
    codes = _codes_of(idx)
    sa = np.asarray(idx.kval).astype(np.uint32)
    big = BigIndex.from_codes(codes, idx.alpha, n_sup=4)
    big.attach_locate(codes, sa)
    return big, sa


def test_big_locate_tables_match_rbt_builders():
    """big_locate_tables/big_marker_tables == the RbtIndex construction."""
    from rowbowt_tpu.index import pack_marker

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    big.attach_markers(sa, [m.text_pos for m in markers],
                       [pack_marker(m.seq, m.pos, m.allele) for m in markers],
                       idx.ma_wsize)
    np.testing.assert_array_equal(big.run_start.astype(np.int64), idx.run_start)
    np.testing.assert_array_equal(big.samples_last.astype(np.int64),
                                  idx.samples_last)
    # the breakpoint phi table must reproduce the dense phi1 (SA adjacency)
    # exactly at every position
    rk = np.searchsorted(big.pred_pos, np.arange(idx.n), side="right") - 1
    phi_all = (big.phi_at.astype(np.int64)[rk]
               + (np.arange(idx.n) - big.pred_pos.astype(np.int64)[rk])) % idx.n
    np.testing.assert_array_equal(phi_all, np.asarray(idx.phi1).astype(np.int64))
    np.testing.assert_array_equal(big.ma_row.astype(np.int64), idx.ma_row)
    np.testing.assert_array_equal(big.ma_val, idx.ma_val)
    # cruns_keys holds run ids grouped by head, ascending within each char
    rr = big.cruns_keys.astype(np.int64) % big.R
    np.testing.assert_array_equal(np.sort(rr), np.arange(big.R))


def test_big_toehold_trajectory_and_locate_parity():
    """The trajectory-postpass toehold + run-space phi walk == the dense
    kval/phi1 engine, lane-exact (locs order: toehold first, phi chain)."""
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    dxb = big.device_index()
    assert "cruns_keys" in dxb.arrays and "kval" not in dxb.arrays
    dxr = DeviceIndex.from_index(idx)
    reads = _reads_of(text, np.random.default_rng(7))
    qc, lens = encode_batch(idx, reads)
    blo, bhi, bk = map(np.asarray, find_ranges_w_toehold(dxb, qc, lens))
    rlo, rhi, rk = map(np.asarray, find_ranges_w_toehold(dxr, qc, lens))
    np.testing.assert_array_equal(blo, rlo)
    np.testing.assert_array_equal(bhi, rhi)
    np.testing.assert_array_equal(bk, rk)
    bl, bc = map(np.asarray, locate(dxb, *find_ranges_w_toehold(dxb, qc, lens),
                                    max_hits=6))
    rl, rc = map(np.asarray, locate(dxr, *find_ranges_w_toehold(dxr, qc, lens),
                                    max_hits=6))
    np.testing.assert_array_equal(bc, rc)
    np.testing.assert_array_equal(bl, rl)


def test_big_markers_parity():
    """Windowed + greedy-seeding marker queries on the BigIndex v2 tables ==
    the replicated dense engine, buffer-exact."""
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.markers import find_ranges_w_markers
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding
    from rowbowt_tpu.index import pack_marker

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    big.attach_markers(sa, [m.text_pos for m in markers],
                       [pack_marker(m.seq, m.pos, m.allele) for m in markers],
                       idx.ma_wsize)
    dxb = big.device_index()
    dxr = DeviceIndex.from_index(idx)
    reads = _reads_of(text, np.random.default_rng(8))
    qc, lens = encode_batch(idx, reads)
    outb = find_ranges_w_markers(dxb, qc, lens, wsize=6, max_range=100, max_k=8)
    outr = find_ranges_w_markers(dxr, qc, lens, wsize=6, max_range=100, max_k=8)
    for a, b in zip(outb, outr):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    gb = markers_greedy_seeding(dxb, qc, lens, wsize=6, max_range=100,
                                max_seeds=4, max_k=8, use_ftab=False)
    gr = markers_greedy_seeding(dxr, qc, lens, wsize=6, max_range=100,
                                max_seeds=4, max_k=8, use_ftab=False)
    for a, b in zip(gb, gr):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_big_v2_save_load_roundtrip(tmp_path):
    from rowbowt_tpu.index import pack_marker

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    big.attach_markers(sa, [m.text_pos for m in markers],
                       [pack_marker(m.seq, m.pos, m.allele) for m in markers],
                       idx.ma_wsize)
    big.doc_starts = np.asarray(idx.doc_starts)
    big.doc_names = list(idx.doc_names)
    p = str(tmp_path / "bigv2")
    big.save(p)
    assert BigIndex.is_big_dir(p) and not BigIndex.is_big_dir(str(tmp_path))
    back = BigIndex.load(p)
    assert back.has_locate and back.has_markers
    assert back.ma_wsize == idx.ma_wsize and back.R == big.R
    for k in BigIndex._OPT:
        v = getattr(big, k)
        if v is not None:
            np.testing.assert_array_equal(np.asarray(getattr(back, k)), v)
    assert back.doc_names == big.doc_names


def test_big_from_merge_order_parity(rand_index):
    """BigIndex v2 built from MERGE-order (codes, sa) — exactly the pangenome
    build pipeline — answers toehold locate row-exact vs the dense engine on
    the same (merge-order) index."""
    from rowbowt_tpu.construct.build import build_index
    from rowbowt_tpu.construct.merge import merge_construct, split_text_docs
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate

    idx, text = rand_index
    parts = split_text_docs(text, idx.doc_starts)
    bwt, sa, alpha = merge_construct(parts, sa_dtype=np.uint32)
    midx = build_index(text, sa=sa.astype(np.int64))
    codes = alpha.encode(alpha.decode(bwt)).astype(np.uint8)  # = bwt already
    big = BigIndex.from_codes(bwt, alpha, n_sup=4)
    big.attach_locate(bwt, sa)
    assert (codes == bwt).all()
    dxb = big.device_index()
    dxm = DeviceIndex.from_index(midx)
    reads = _reads_of(text, np.random.default_rng(5))
    qc, lens = encode_batch(midx, reads)
    rb = find_ranges_w_toehold(dxb, qc, lens)
    rm = find_ranges_w_toehold(dxm, qc, lens)
    for a, b in zip(rb, rm):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    lb, cb = locate(dxb, *rb, max_hits=5)
    lm, cm = locate(dxm, *rm, max_hits=5)
    np.testing.assert_array_equal(np.asarray(cb), np.asarray(cm))
    np.testing.assert_array_equal(np.asarray(lb), np.asarray(lm))


def test_big_sharded_locate_and_markers_parity():
    """The 8-way position-sharded engines (sharded LF + replicated O(R)/O(M)
    tables) == the single-device big engine: toehold, phi-walk locate, and
    greedy genotyping, buffer-exact on the virtual mesh."""
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding
    from rowbowt_tpu.index import pack_marker
    from rowbowt_tpu.parallel.mesh import make_mesh
    from rowbowt_tpu.parallel.sharded_dense import (
        find_ranges_w_toehold_sharded_dense, locate_sharded_dense,
        markers_greedy_seeding_sharded_dense,
    )

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    big.attach_markers(sa, [m.text_pos for m in markers],
                       [pack_marker(m.seq, m.pos, m.allele) for m in markers],
                       idx.ma_wsize)
    sdx = big.sharded_index()
    assert sdx.big_tables is not None and sdx.kval2 is None
    mesh = make_mesh(n_dp=2, n_idx=4)
    tables = sdx.device_put(mesh)
    dxb = big.device_index()
    reads = _reads_of(text, np.random.default_rng(9), k=32)
    qc, lens = encode_batch(idx, reads)
    if qc.shape[0] % 2:  # lanes must divide the dp axis
        qc = np.concatenate([qc, np.full((1, qc.shape[1]), -1, qc.dtype)])
        lens = np.concatenate([lens, np.zeros(1, lens.dtype)])

    slo, shi, sk = map(np.asarray, find_ranges_w_toehold_sharded_dense(
        mesh, sdx, tables, qc, lens))
    rlo, rhi, rk = map(np.asarray, find_ranges_w_toehold(dxb, qc, lens))
    np.testing.assert_array_equal(slo, rlo)
    np.testing.assert_array_equal(shi, rhi)
    np.testing.assert_array_equal(sk, rk)

    sl_, sc_ = map(np.asarray, locate_sharded_dense(
        mesh, sdx, tables, rlo, rhi, rk, max_hits=5))
    rl_, rc_ = map(np.asarray, locate(dxb, rlo, rhi, rk, max_hits=5))
    np.testing.assert_array_equal(sc_, rc_)
    np.testing.assert_array_equal(sl_, rl_)

    gs = markers_greedy_seeding_sharded_dense(
        mesh, sdx, tables, qc, lens, wsize=6, max_range=100,
        max_seeds=4, max_k=8)
    gr = markers_greedy_seeding(dxb, qc, lens, wsize=6, max_range=100,
                                max_seeds=4, max_k=8, use_ftab=False)
    for a, b in zip(gs, gr):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_big_seeds_greedy_w_sample_parity():
    """Per-seed toeholds via the trajectory-SPAN resolve (big layout) ==
    the dense kval engine, and locate_from_longest_seed end to end."""
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.seeds import (
        locate_from_longest_seed, seeds_greedy_w_sample,
    )

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    dxb = big.device_index()
    dxr = DeviceIndex.from_index(idx)
    rng = np.random.default_rng(21)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for i in range(24):  # longer reads with a mutation: multiple seeds/lane
        L = int(rng.integers(20, 60))
        p = int(rng.integers(0, len(text) - L))
        r = np.array(text[p:p + L])
        r[int(rng.integers(0, L))] = acgt[int(rng.integers(0, 4))]
        if np.isin(r, acgt).all():
            reads.append(bytes(r))
    qc, lens = encode_batch(idx, reads)
    rb = [np.asarray(x) for x in seeds_greedy_w_sample(dxb, qc, lens,
                                                       min_length=5)]
    rr = [np.asarray(x) for x in seeds_greedy_w_sample(dxr, qc, lens,
                                                       min_length=5)]
    for name, a, b in zip(("slo", "shi", "sqs", "sqe", "ssamp", "ns"), rb, rr):
        np.testing.assert_array_equal(a, b, err_msg=name)
    lb, cb = map(np.asarray, locate_from_longest_seed(
        dxb, *[np.asarray(x) for x in rb[:5]], rb[5], max_hits=4))
    lr, cr = map(np.asarray, locate_from_longest_seed(
        dxr, *[np.asarray(x) for x in rr[:5]], rr[5], max_hits=4))
    np.testing.assert_array_equal(cb, cr)
    np.testing.assert_array_equal(lb, lr)


def test_big_chkpnts_parity():
    """find_range_w_toehold_chkpnts (rowbowt.hpp:575-611) on the big layout:
    per-checkpoint toeholds via the prefix-span resolve == the dense engine."""
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold_chkpnts

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    dxb = big.device_index()
    dxr = DeviceIndex.from_index(idx)
    reads = _reads_of(text, np.random.default_rng(33), k=24)
    qc, lens = encode_batch(idx, reads)
    rb = find_ranges_w_toehold_chkpnts(dxb, qc, lens, wsize=5)
    rr = find_ranges_w_toehold_chkpnts(dxr, qc, lens, wsize=5)
    ncp = np.asarray(rr[5])
    for name, a, b in zip(("clo", "chi", "ck", "cqs", "cqe"), rb, rr):
        a, b = np.asarray(a), np.asarray(b)
        # compare recorded slots only (unrecorded ck slots differ in fill)
        for lane in range(a.shape[0]):
            c = int(ncp[lane])
            np.testing.assert_array_equal(a[lane, :c], b[lane, :c],
                                          err_msg=f"{name} lane {lane}")
    np.testing.assert_array_equal(np.asarray(rb[5]), ncp)


def test_marker_nibble_rank_matches_dense(monkeypatch):
    """The one-gather nibble-count marker rank == dense ma_start1 at every
    position, and the device markers path dispatches through it (opt-in
    via RBT_MA_NIB, bigindex._ma_cnt64)."""
    from rowbowt_tpu.bigindex import marker_nibble_rank
    from rowbowt_tpu.index import pack_marker
    from rowbowt_tpu.ops import rank as RK
    import jax.numpy as jnp

    import rowbowt_tpu.bigindex as BI

    monkeypatch.setenv("RBT_MA_NIB", "1")
    # the run-pack rank outranks the nibble rows; disable it so the device
    # dispatch lands on the nibble path under test
    monkeypatch.setattr(BI, "marker_run_pack", lambda *a: None)
    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    big.attach_markers(sa, [m.text_pos for m in markers],
                       [pack_marker(m.seq, m.pos, m.allele) for m in markers],
                       idx.ma_wsize)
    nib = marker_nibble_rank(big.ma_row, big.n)
    assert nib is not None
    dxb = big.device_index()
    assert "ma_cnt64" in dxb.arrays and "ma_off" not in dxb.arrays
    i = jnp.arange(big.n + 1, dtype=jnp.int64)
    got = np.asarray(RK._ms_nibble(dxb, i))
    np.testing.assert_array_equal(got, np.asarray(idx.ma_start1).astype(np.int64))
    # overflow guard: a row with 16 entries must refuse
    fake = np.sort(np.concatenate([big.ma_row[:50],
                                   np.full(16, 7, dtype=big.ma_row.dtype)]))
    assert marker_nibble_rank(fake, big.n) is None


def test_big_locate_ragged_parity():
    """The ragged unbounded walk (rb_align -s contract) on the big layout ==
    the dense engine: same flat occurrence stream, same offsets."""
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate_ragged

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    dxb = big.device_index()
    dxr = DeviceIndex.from_index(idx)
    rng = np.random.default_rng(41)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    for _ in range(20):  # short reads: wide ranges, long phi chains
        L = int(rng.integers(3, 10))
        p = int(rng.integers(0, len(text) - L))
        r = text[p:p + L]
        if np.isin(r, acgt).all():
            reads.append(bytes(r))
    qc, lens = encode_batch(idx, reads)
    rb = find_ranges_w_toehold(dxb, qc, lens)
    fb_, ob = locate_ragged(dxb, *rb)
    rr = find_ranges_w_toehold(dxr, qc, lens)
    fr_, orr = locate_ragged(dxr, *rr)
    np.testing.assert_array_equal(ob, orr)
    np.testing.assert_array_equal(fb_, fr_)
    assert ob[-1] > len(reads)  # short patterns actually fanned out


def test_phi_bitmap_rank_matches_breakpoint_table():
    """The bitmap-rank phi (phi_pack_tables + phi_step "phi_rows" branch)
    must equal the breakpoint-table phi at EVERY text position."""
    import jax
    import jax.numpy as jnp

    from rowbowt_tpu.ops import rank as RK

    idx, text, markers = _marker_fixture()
    big, sa = _big_v2(idx)
    rk = np.searchsorted(big.pred_pos, np.arange(big.n), side="right") - 1
    exp = (big.phi_at.astype(np.int64)[rk]
           + (np.arange(big.n) - big.pred_pos.astype(np.int64)[rk])) % big.n
    dxb = big.device_index()
    assert "phi_rows" in dxb.arrays and "pred_pos" not in dxb.arrays
    got = np.asarray(jax.jit(RK.phi_step)(
        dxb, jnp.arange(big.n, dtype=jnp.int64)))
    np.testing.assert_array_equal(got, exp)


def test_marker_run_pack_rank_matches_searchsorted():
    """The run-pack marker rank (marker_run_pack + _ms_runs: 3 dependent
    gather levels, ~8 MB of tables) must equal lower_bound(ma_row, q) at
    random, boundary, and in-run query points."""
    import jax.numpy as jnp

    from rowbowt_tpu.bigindex import marker_run_pack
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.ops.rank import _ms_runs

    rng = np.random.default_rng(3)
    n = 5_000_000
    rows = []
    for _ in range(200):  # clustered runs, mults 1-3, like a real panel
        base = rng.integers(0, n - 5000)
        for r in range(rng.integers(1, 6)):
            start = base + r * rng.integers(10, 400)
            rows.append(np.repeat(
                np.arange(start, start + rng.integers(1, 120)),
                rng.integers(1, 4)))
    rows.append(rng.integers(0, n, size=500))  # isolated singletons
    ma_row = np.sort(np.concatenate(rows)).astype(np.int64)
    M = ma_row.shape[0]
    off, sd16, rec, ma_rp = marker_run_pack(ma_row, n)
    dx = DeviceIndex(
        arrays={"ma_roff": jnp.asarray(off), "ma_sd16": jnp.asarray(sd16),
                "ma_rec": jnp.asarray(rec), "F": jnp.zeros(7, jnp.int64)},
        n=n, R=0, A=6, ma_wsize=10, ftab_k=0, acgt_codes=(2, 3, 4, 5),
        ma_rp=ma_rp)
    q = np.concatenate([rng.integers(0, n + 1, size=4000),
                        ma_row[rng.integers(0, M, size=2000)],
                        ma_row[rng.integers(0, M, size=2000)] + 1,
                        [0, n, int(ma_row[0]), int(ma_row[-1]) + 1]
                        ]).astype(np.int64)
    got = np.asarray(_ms_runs(dx, jnp.asarray(q)))
    np.testing.assert_array_equal(got, np.searchsorted(ma_row, q, "left"))


def test_marker_run_pack_falls_back_on_degenerate_structure():
    """mult > 127 must return None (the bucketed lower bound then serves,
    ops.rank markers_bounds "ma_off" branch); dense short runs instead
    ADAPT the bucket shift downward and stay exact."""
    import jax.numpy as jnp

    from rowbowt_tpu.bigindex import marker_run_pack
    from rowbowt_tpu.engine.device import DeviceIndex
    from rowbowt_tpu.ops.rank import _ms_runs

    # one row with 200 markers -> mult cap
    assert marker_run_pack(
        np.full(200, 17, dtype=np.int64), 1000) is None
    # 2000 isolated single-row runs packed into one 64k span: needs a
    # sub-16 shift (97+ runs per bucket would overflow the 4-row unroll)
    dense = np.arange(0, 4000, 2, dtype=np.int64) + (5 << 16)
    n = 10_000_000
    off, sd16, rec, (shift, nrows) = marker_run_pack(dense, n)
    assert shift < 16 and nrows <= 4
    dx = DeviceIndex(
        arrays={"ma_roff": jnp.asarray(off), "ma_sd16": jnp.asarray(sd16),
                "ma_rec": jnp.asarray(rec), "F": jnp.zeros(7, jnp.int64)},
        n=n, R=0, A=6, ma_wsize=10, ftab_k=0, acgt_codes=(2, 3, 4, 5),
        ma_rp=(shift, nrows))
    q = np.concatenate([np.arange(0, 4100) + (5 << 16) - 50,
                        [0, n]]).astype(np.int64)
    got = np.asarray(_ms_runs(dx, jnp.asarray(q)))
    np.testing.assert_array_equal(got, np.searchsorted(dense, q, "left"))
