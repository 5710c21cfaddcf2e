"""PFP construction (construct/pfp.py + native/pfp.cpp) vs the whole-text
suffix-array oracle: every table the pipeline emits — run-length BWT, F,
fused-block rank rows, run-boundary SA samples, exact phi breakpoints,
marker CSR — must be byte-identical to BigIndex built from the full SA-IS
suffix array under the standard order.  Plus count-range equality against
the generalized-order merge construction (range bounds are order-invariant
for in-alphabet patterns)."""

import numpy as np
import pytest

from rowbowt_tpu.alphabet import SEP_BYTE, TERM_BYTE, Alphabet
from rowbowt_tpu.bigindex import BigIndex
from rowbowt_tpu.construct.sa import suffix_array



@pytest.fixture(autouse=True)
def _needs_native_pfp(native_lib):
    if native_lib is None or not hasattr(native_lib, "rbt_pfp_new"):
        pytest.skip("native pfp library not built")


def _panel(rng, ref_len=400, n_haps=3, n_vars=12, w=4):
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    ref = rng.choice(acgt, size=ref_len)
    var_pos = np.sort(rng.choice(ref_len, size=n_vars, replace=False))
    var_alt = rng.choice(acgt, size=n_vars)
    sep = np.full(w, SEP_BYTE, dtype=np.uint8)
    parts = [np.concatenate([ref, sep])]
    markers = [(int(p), 0) for p in var_pos]  # (ref pos, allele) on doc 0
    tpos = list(var_pos.astype(np.int64))
    doc_len = ref_len + w
    for h in range(n_haps):
        hap = ref.copy()
        carry = rng.random(n_vars) < 0.5
        hap[var_pos[carry]] = var_alt[carry]
        tail = (sep if h < n_haps - 1 else
                np.concatenate([sep, np.array([TERM_BYTE], dtype=np.uint8)]))
        parts.append(np.concatenate([hap, tail]))
        tpos.extend(((h + 1) * doc_len + var_pos).astype(np.int64))
        markers.extend((int(p), int(c)) for p, c in zip(var_pos, carry))
    packed = [(int(p) << 8) | a for (p, a), tp in zip(markers, tpos)]
    return parts, np.array(tpos, dtype=np.int64), np.array(packed,
                                                          dtype=np.int64)


def _oracle_big(text, alpha, n_sup, tpos, packed, wsize):
    sa = suffix_array(text)
    tab = alpha.encode_table()
    n = text.shape[0]
    bwt = tab[text[(sa.astype(np.int64) - 1) % n].astype(np.int64)]
    bwt = bwt.astype(np.uint8)
    big = BigIndex.from_codes(bwt, alpha, n_sup=n_sup)
    big.attach_locate(bwt, sa)
    big.attach_markers(sa, tpos, packed, wsize)
    return big, sa


def _pfp_big(parts, alpha, w, p, tpos, packed, wsize, block=128):
    from rowbowt_tpu.construct import pfp

    n = sum(int(x.shape[0]) for x in parts)
    probes = pfp.marker_window_positions(tpos, wsize)
    res = pfp.pfp_construct(parts, w=w, p=p, probe_pos=probes)
    n_sup = max(2, -(-n // ((n + 3) // 4)))
    big = pfp.assemble_bigindex(res, alpha, block=block,
                                sup_syms=(n + 3) // 4)
    pfp.attach_markers_from_probes(big, res, tpos, packed, wsize)
    return big, res


@pytest.mark.parametrize("seed,w,p", [(1, 4, 5), (2, 6, 17), (3, 10, 31)])
def test_pfp_matches_whole_text_oracle(seed, w, p):
    rng = np.random.default_rng(seed)
    parts, tpos, packed = _panel(rng, w=4)
    text = np.concatenate(parts)
    alpha = Alphabet(np.unique(text))
    wsize = 5
    ob, sa = _oracle_big(text, alpha, 4, tpos, packed, wsize)
    pb, res = _pfp_big(parts, alpha, w, p, tpos, packed, wsize)
    assert pb.n == ob.n and pb.R == ob.R and pb.per_blk == ob.per_blk
    np.testing.assert_array_equal(pb.F, ob.F)
    np.testing.assert_array_equal(pb.run_head, ob.run_head)
    np.testing.assert_array_equal(np.asarray(pb.run_start),
                                  np.asarray(ob.run_start))
    np.testing.assert_array_equal(np.asarray(pb.samples_last),
                                  np.asarray(ob.samples_last))
    np.testing.assert_array_equal(np.asarray(pb.pred_pos),
                                  np.asarray(ob.pred_pos))
    np.testing.assert_array_equal(np.asarray(pb.phi_at),
                                  np.asarray(ob.phi_at))
    np.testing.assert_array_equal(pb.cruns_keys, ob.cruns_keys)
    np.testing.assert_array_equal(pb.fb2, ob.fb2)
    np.testing.assert_array_equal(pb.base, ob.base)
    np.testing.assert_array_equal(np.asarray(pb.ma_row),
                                  np.asarray(ob.ma_row))
    np.testing.assert_array_equal(pb.ma_val, ob.ma_val)
    # run-boundary SA values really are SA (first/last row of each run)
    run_end = np.concatenate((np.asarray(pb.run_start)[1:] - 1, [pb.n - 1]))
    np.testing.assert_array_equal(res.run_sa_first,
                                  sa[np.asarray(pb.run_start).astype(np.int64)])
    np.testing.assert_array_equal(res.run_sa_last, sa[run_end])


def test_pfp_random_text_no_panel_structure():
    """Unstructured random text (no separators, any alphabet) still matches."""
    rng = np.random.default_rng(9)
    body = rng.choice(np.frombuffer(b"ACGTN", dtype=np.uint8), size=1500)
    text = np.concatenate([body, [np.uint8(TERM_BYTE)]])
    alpha = Alphabet(np.unique(text))
    ob, sa = _oracle_big(text, alpha, 3, np.array([5]), np.array([0]), 3)
    pb, res = _pfp_big([text], alpha, 5, 7, np.array([5]), np.array([0]), 3)
    np.testing.assert_array_equal(pb.run_head, ob.run_head)
    np.testing.assert_array_equal(np.asarray(pb.run_start),
                                  np.asarray(ob.run_start))
    np.testing.assert_array_equal(np.asarray(pb.samples_last),
                                  np.asarray(ob.samples_last))
    np.testing.assert_array_equal(np.asarray(pb.pred_pos),
                                  np.asarray(ob.pred_pos))
    np.testing.assert_array_equal(np.asarray(pb.phi_at), np.asarray(ob.phi_at))
    np.testing.assert_array_equal(np.asarray(pb.ma_row), np.asarray(ob.ma_row))


def test_pfp_repetitive_text():
    """Highly repetitive text (tandem repeats) exercises deep shared-suffix
    groups and long runs."""
    rng = np.random.default_rng(21)
    unit = rng.choice(np.frombuffer(b"ACGT", dtype=np.uint8), size=37)
    body = np.tile(unit, 60)
    body[rng.integers(0, body.shape[0], size=15)] = ord("A")
    text = np.concatenate([body, [np.uint8(TERM_BYTE)]])
    alpha = Alphabet(np.unique(text))
    ob, sa = _oracle_big(text, alpha, 2, np.array([9]), np.array([1]), 4)
    pb, res = _pfp_big([text], alpha, 4, 5, np.array([9]), np.array([1]), 4)
    np.testing.assert_array_equal(pb.run_head, ob.run_head)
    np.testing.assert_array_equal(np.asarray(pb.run_start),
                                  np.asarray(ob.run_start))
    np.testing.assert_array_equal(np.asarray(pb.samples_last),
                                  np.asarray(ob.samples_last))
    np.testing.assert_array_equal(np.asarray(pb.pred_pos),
                                  np.asarray(ob.pred_pos))
    np.testing.assert_array_equal(np.asarray(pb.phi_at), np.asarray(ob.phi_at))


def test_pfp_256_block_rank_rows():
    """The 256-symbol/160B fb2 layout (giant-config row shape) ranks
    identically: device count over fb2_256 == naive over the oracle codes."""
    import jax.numpy as jnp

    from rowbowt_tpu.engine import naive
    from rowbowt_tpu.engine.count import find_ranges
    from rowbowt_tpu.index import RbtIndex  # noqa: F401 (alphabet deps)

    rng = np.random.default_rng(31)
    parts, tpos, packed = _panel(rng, ref_len=600, w=4)
    text = np.concatenate(parts)
    alpha = Alphabet(np.unique(text))
    pb, res = _pfp_big(parts, alpha, 6, 11, tpos, packed, 5, block=256)
    assert pb.fb2.shape[1] == 40
    dx = pb.device_index(fb64=False)
    assert "fb2_256" in dx.arrays
    # CPU oracle over the whole-text BWT codes
    tab = alpha.encode_table()
    sa = suffix_array(text)
    bwt = tab[text[(sa.astype(np.int64) - 1) % len(text)].astype(np.int64)]
    ob = BigIndex.from_codes(bwt.astype(np.uint8), alpha, n_sup=2)
    reads = []
    for _ in range(24):
        L = int(rng.integers(4, 30))
        s = int(rng.integers(0, len(text) - L))
        reads.append(text[s:s + L])
    qc = np.full((len(reads), 32), -1, dtype=np.int32)
    lens = np.zeros(len(reads), dtype=np.int32)
    for i, r in enumerate(reads):
        qc[i, 32 - len(r):] = tab[r.astype(np.int64)]
        lens[i] = len(r)
    lo, hi = map(np.asarray, find_ranges(dx, jnp.asarray(qc),
                                         jnp.asarray(lens)))
    from rowbowt_tpu.cpu_backend import count_ranges_fb2
    clo, chi = count_ranges_fb2(ob, qc.astype(np.int16), lens)
    np.testing.assert_array_equal(lo, clo)
    np.testing.assert_array_equal(hi, chi)


def test_pfp_count_ranges_equal_merge_order():
    """Count ranges are identical under the PFP (standard) and merge
    (generalized) suffix orders for in-alphabet patterns — the invariance the
    module docstring claims (range bounds are fixed by pattern-prefix
    comparisons, which the two orders share)."""
    from rowbowt_tpu.construct.merge import merge_construct
    from rowbowt_tpu.cpu_backend import count_ranges_fb2

    rng = np.random.default_rng(77)
    parts, tpos, packed = _panel(rng, ref_len=500, n_haps=4, w=4)
    text = np.concatenate(parts)
    alpha = Alphabet(np.unique(text))
    pb, res = _pfp_big(parts, alpha, 5, 9, tpos, packed, 5)
    mcodes, msa, malpha = merge_construct(parts, alpha=alpha, with_sa=False,
                                          prefetch=False)
    mb = BigIndex.from_codes(mcodes, alpha, n_sup=2)
    tab = alpha.encode_table()
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    qs, lens = [], []
    L = 24
    while len(qs) < 40:
        s = int(rng.integers(0, len(text) - L))
        r = text[s:s + L]
        if not np.isin(r, acgt).all():
            continue  # reads never contain separators (rb_align contract)
        qs.append(tab[r.astype(np.int64)])
        lens.append(L)
    qc = np.stack(qs).astype(np.int16)
    lens = np.array(lens, dtype=np.int32)
    # the pfp index has 128-sym rows here -> CPU fb2 path works on both
    plo, phi_ = count_ranges_fb2(pb, qc, lens)
    mlo, mhi = count_ranges_fb2(mb, qc, lens)
    np.testing.assert_array_equal(plo, mlo)
    np.testing.assert_array_equal(phi_, mhi)
