"""All three rank backends (run-space searchsorted, block-dense, occ1) must
agree with the naive engine on the same text."""

import numpy as np
import pytest

from rowbowt_tpu.construct.build import build_index
from rowbowt_tpu.engine import naive
from rowbowt_tpu.engine.batch import encode_batch
from rowbowt_tpu.engine.count import find_ranges
from rowbowt_tpu.engine.device import DeviceIndex
from rowbowt_tpu.engine.locate import find_ranges_w_toehold, locate


@pytest.fixture(scope="module")
def text():
    rng = np.random.default_rng(11)
    t = rng.choice(np.frombuffer(b"ACGT", np.uint8), size=700)
    return np.concatenate([t, np.array([1], dtype=np.uint8)])


@pytest.fixture(scope="module")
def reads(text):
    rng = np.random.default_rng(12)
    out = []
    for _ in range(24):
        L = int(rng.integers(3, 25))
        p = int(rng.integers(0, len(text) - L - 1))
        r = text[p:p + L].copy()
        if rng.random() < 0.4:
            r[rng.integers(0, L)] = rng.choice(np.frombuffer(b"ACGT", np.uint8))
        out.append(bytes(r))
    return out


def test_rank_backends_pointwise(text):
    """rank_fblock / rank_dense / rank_occ1 == run-space rank on random (i, c),
    including the i == n and c < 0 edges."""
    import jax.numpy as jnp

    from rowbowt_tpu.construct.build import build_dense_tables, build_occ1
    from rowbowt_tpu.ops import rank as R

    idx = build_index(text)
    assert idx.fblock is not None
    dx = DeviceIndex.from_index(idx, fb64=False)  # keep the raw 96B rows addressable
    # fblock replaces occ1 and the split pair in panel builds; synthesize both
    # so every rank backend is exercised against the run-space oracle
    codes = _bwt_codes(idx)
    bwt4, occ_blk = build_dense_tables(codes, idx.A)
    dx.arrays["bwt4"] = jnp.asarray(bwt4)
    dx.arrays["occ_blk_flat"] = jnp.asarray(occ_blk.astype(np.int32).reshape(-1))
    dx.arrays["occ1_flat"] = jnp.asarray(
        build_occ1(codes, idx.A).astype(np.int32).reshape(-1))

    rng = np.random.default_rng(5)
    i = jnp.asarray(rng.integers(0, idx.n + 1, size=2048, dtype=np.int32))
    c = jnp.asarray(rng.integers(-1, idx.A, size=2048, dtype=np.int32))
    base = np.asarray(R.rank(dx, i, c))
    assert (np.asarray(R.rank_fblock(dx, i, c)) == base).all()
    assert (np.asarray(R.rank_dense(dx, i, c)) == base).all()
    assert (np.asarray(R.rank_occ1(dx, i, c)) == base).all()


def test_rank_fblock64_parity(text):
    """The 64-symbol/64B-row repack (fblock_to_fb64) == rank_fblock on random
    (i, c) incl. the i == n and c < 0 edges, and the repacked rows are exact:
    even children keep the parent checkpoint, odd add the first-half counts."""
    import jax.numpy as jnp

    from rowbowt_tpu.construct.build import fblock_to_fb64
    from rowbowt_tpu.ops import rank as R

    idx = build_index(text)
    dx = DeviceIndex.from_index(idx, fb64=False)
    fb64 = fblock_to_fb64(idx.fblock, idx.n)
    assert fb64.shape == (2 * idx.fblock.shape[0], 16)
    # oracle checkpoints from the code sequence
    codes = _bwt_codes(idx)
    pad = np.full((-len(codes)) % 64, 15, dtype=np.int64)
    pc = np.concatenate([codes, pad]).reshape(-1, 64)
    for c in range(idx.A):
        exp = np.concatenate([[0], np.cumsum((pc == c).sum(axis=1))[:-1]])
        assert (fb64[: len(exp), c] == exp).all()
    dx.arrays["fblock64"] = jnp.asarray(fb64)
    rng = np.random.default_rng(7)
    i = jnp.asarray(rng.integers(0, idx.n + 1, size=2048, dtype=np.int32))
    c = jnp.asarray(rng.integers(-1, idx.A, size=2048, dtype=np.int32))
    assert (np.asarray(R.rank_fblock64(dx, i, c))
            == np.asarray(R.rank_fblock(dx, i, c))).all()


def test_fb64_full_engine_agreement(text, reads):
    """A forced-fb64 DeviceIndex drives every engine path identically: the
    layout choice is invisible above lf_step_auto."""
    idx = build_index(text)
    dx96 = DeviceIndex.from_index(idx, fb64=False)
    dx64 = DeviceIndex.from_index(idx, fb64=True)
    assert "fblock64" in dx64.arrays and "fblock" not in dx64.arrays
    qc, lens = encode_batch(idx, reads)
    for a, b in zip(find_ranges(dx96, qc, lens), find_ranges(dx64, qc, lens)):
        assert (np.asarray(a) == np.asarray(b)).all()
    for a, b in zip(find_ranges_w_toehold(dx96, qc, lens),
                    find_ranges_w_toehold(dx64, qc, lens)):
        assert (np.asarray(a) == np.asarray(b)).all()


def test_dual_layout_default_and_greedy_parity(tiny_index_ftab, reads):
    """The default load keeps BOTH row layouts below FB96_KEEP_MAX_N; the
    greedy engine (prefer_fb96) must return buffer-identical results on the
    dual-layout index and on each single-layout index."""
    from rowbowt_tpu.construct.build import FB96_KEEP_MAX_N
    from rowbowt_tpu.engine.seeds import markers_greedy_seeding

    idx = tiny_index_ftab
    assert idx.n < FB96_KEEP_MAX_N
    dxd = DeviceIndex.from_index(idx)  # default: dual layout
    assert "fblock64" in dxd.arrays and "fblock" in dxd.arrays
    qc, lens = encode_batch(idx, reads)
    outs = []
    for dx in (dxd, DeviceIndex.from_index(idx, fb64=True),
               DeviceIndex.from_index(idx, fb64=False)):
        # use_ftab=False: wsize=4 < ftab_k-1 trips the reference-mandated
        # guard (rowbowt.hpp:423-426); the dual-layout property is about the
        # rank backend, not ftab replay, so test the plain greedy path here.
        outs.append(markers_greedy_seeding(dx, qc, lens, wsize=4,
                                           max_range=50, max_seeds=4, max_k=8,
                                           use_ftab=False))
    for o in outs[1:]:
        for a, b in zip(outs[0], o):
            assert (np.asarray(a) == np.asarray(b)).all()


def _bwt_codes(idx):
    ends = np.append(idx.run_start[1:], idx.n)
    return np.repeat(idx.run_head.astype(np.int64), ends - idx.run_start)


@pytest.mark.parametrize("dense", [False, True])
def test_backend_agreement(text, reads, dense):
    idx = build_index(text, dense=dense)
    if dense:
        assert idx.kval is not None and idx.fblock is not None
        assert idx.occ1 is None  # superseded by fblock for panel builds
    dx = DeviceIndex.from_index(idx)
    qc, lens = encode_batch(idx, reads)
    lo, hi = find_ranges(dx, qc, lens)
    tlo, thi, k = find_ranges_w_toehold(dx, qc, lens)
    locs, cnt = locate(dx, tlo, thi, k, max_hits=8)
    lo, hi, tlo, thi, k, locs, cnt = map(np.asarray, (lo, hi, tlo, thi, k, locs, cnt))
    for b, r in enumerate(reads):
        codes = idx.alpha.encode(np.frombuffer(r, np.uint8)).astype(np.int64)
        assert (lo[b], hi[b]) == naive.find_range(idx, codes)
        wrn, wk = naive.find_range_w_toehold(idx, codes)
        assert (tlo[b], thi[b]) == wrn
        if wrn[1] >= wrn[0]:
            assert k[b] == wk
            assert list(locs[b, : cnt[b]]) == naive.locate_range(idx, *wrn, wk, 8)


def test_cpu_fb2_engines_match_naive():
    """The single-thread CPU locate/markers/greedy engines (bench baselines,
    native/cpu_engine.cpp) == the naive reference spec, read by read."""
    import pytest

    from rowbowt_tpu import cpu_backend
    from rowbowt_tpu.bigindex import BigIndex
    from rowbowt_tpu.engine import naive

    from tests.test_bigindex import _marker_fixture

    if not cpu_backend.available():
        pytest.skip("no native lib")
    idx, text, markers = _marker_fixture()
    run_len = np.diff(np.append(idx.run_start, idx.n))
    codes = np.repeat(idx.run_head.astype(np.uint8), run_len)
    big = BigIndex.from_codes(codes, idx.alpha, n_sup=3)
    big.attach_locate(codes, np.asarray(idx.kval).astype(np.uint32))
    big.ma_row = np.asarray(idx.ma_row).astype(np.uint32)
    big.ma_val = np.asarray(idx.ma_val)
    big.ma_wsize = idx.ma_wsize

    rng = np.random.default_rng(123)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    reads = []
    while len(reads) < 30:
        L = int(rng.integers(8, 40))
        s = int(rng.integers(0, len(text) - L))
        r = text[s:s + L]
        if np.isin(r, acgt).all():
            reads.append(r)
    stride = max(len(r) for r in reads)
    qc = np.full((len(reads), stride), -1, dtype=np.int16)
    lens = np.zeros(len(reads), dtype=np.int32)
    tab = idx.alpha.encode_table()
    for i, r in enumerate(reads):
        qc[i, stride - len(r):] = tab[r.astype(np.int64)]
        lens[i] = len(r)

    lo, hi, k, locs, cnt = cpu_backend.locate_fb2(big, qc, lens, max_hits=5)
    mlo, mhi, mcnt = cpu_backend.markers_fb2(big, qc, lens, wsize=6,
                                             max_range=200)
    gns, gmc = cpu_backend.greedy_fb2(big, qc, lens, wsize=6, max_range=200)
    for i, r in enumerate(reads):
        cr = tab[r.astype(np.int64)].astype(np.int64)
        (nlo, nhi), nk = naive.find_range_w_toehold(idx, cr)
        assert (lo[i], hi[i], k[i]) == (nlo, nhi, nk), (i, r)
        nl = naive.locate_range(idx, nlo, nhi, nk, 5) if nhi >= nlo else []
        got = [x for x in locs[i] if x >= 0]
        assert got == nl, (i, got, nl)
        lf = naive.find_range_w_markers(idx, cr, 6, 200)
        assert mcnt[i] == len(lf.markers), (i, mcnt[i], len(lf.markers))
        seeds = []
        naive.get_markers_greedy_seeding(
            idx, cr, 6, 200, lambda rn, span, mb: seeds.append(len(mb)),
            use_ftab=False)
        assert gns[i] == len(seeds), (i, gns[i], len(seeds))
        assert gmc[i] == sum(seeds), (i, gmc[i], sum(seeds))
