"""Native C++ DP engine parity and performance sanity."""

import numpy as np
import pytest

from ngspeciesid import native
from ngspeciesid.ops.align import (
    block_stats_batch,
    identity_batch,
    sg_align_batch,
)

pytestmark = pytest.mark.skipif(not native.available(),
                                reason="no C++ toolchain for the native engine")


def rand_seq(rng, n):
    return rng.integers(65, 69, size=n).astype(np.uint8)


def mutate(rng, s, rate):
    out = []
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue
        out.append(int(c))
        if r < 2 * rate / 3:
            out.append(int(rng.integers(65, 69)))
    return np.array(out, dtype=np.uint8)


class TestNativeParity:
    def test_random_pairs(self, rng):
        pairs, opens = [], []
        for _ in range(50):
            pairs.append((rand_seq(rng, int(rng.integers(5, 200))),
                          rand_seq(rng, int(rng.integers(5, 200)))))
            opens.append(int(rng.choice([2, 3, 4, 5])))
        got = native.align_batch_native(pairs, opens)
        want = sg_align_batch(pairs, opens, backend="numpy")
        for g, w in zip(got, want):
            assert g.tolist() == w.tolist()

    def test_related_pairs(self, rng):
        pairs, opens = [], []
        for _ in range(20):
            a = rand_seq(rng, int(rng.integers(50, 400)))
            b = mutate(rng, a, 0.12)
            pairs.append((a, b))
            opens.append(2)
        got = native.align_batch_native(pairs, opens)
        want = sg_align_batch(pairs, opens, backend="numpy")
        for g, w in zip(got, want):
            assert g.tolist() == w.tolist()

    def test_auto_backend_uses_native(self, rng):
        pairs = [(rand_seq(rng, 40), rand_seq(rng, 44))]
        got = sg_align_batch(pairs, [3])          # auto -> native on host
        want = sg_align_batch(pairs, [3], backend="numpy")
        assert got[0].tolist() == want[0].tolist()


class TestStatsDispatchParity:
    """block_stats_batch / identity_batch must agree across backends."""

    def _pairs(self, rng):
        pairs, opens, ks, mids = [], [], [], []
        for _ in range(12):
            a = rand_seq(rng, int(rng.integers(40, 150)))
            b = mutate(rng, a, 0.1)
            if b.size < 5:
                b = rand_seq(rng, 20)
            pairs.append((a, b))
            opens.append(int(rng.choice([2, 3, 5])))
            ks.append(13)
            mids.append(int(rng.integers(1, 14)))
        return pairs, opens, ks, mids

    def test_block_stats_native_vs_host(self, rng):
        pairs, opens, ks, mids = self._pairs(rng)
        got = block_stats_batch(pairs, opens, ks, mids, backend="native")
        want = block_stats_batch(pairs, opens, ks, mids, backend="host")
        for g, w in zip(got, want):
            assert g == pytest.approx(w, abs=0.0)

    def test_identity_native_vs_host(self, rng):
        pairs, opens, _, _ = self._pairs(rng)
        got = identity_batch(pairs, opens, backend="native")
        want = identity_batch(pairs, opens, backend="host")
        assert got == pytest.approx(want, abs=0.0)

    def test_env_override(self, rng, monkeypatch):
        from ngspeciesid.ops import align as align_mod
        monkeypatch.setenv("NGSID_STATS_BACKEND", "host")
        assert align_mod.stats_backend_default() == "host"
        monkeypatch.delenv("NGSID_STATS_BACKEND")
        assert align_mod.stats_backend_default() in ("native", "device", "host")


class TestReadErrorStats:
    """read_error_stats_native must equal the numpy accumulation bit-for-bit."""

    def test_bit_identical(self, rng):
        from ngspeciesid.cluster.store import _full_error_rate, _hpol_error_rate
        from ngspeciesid.utils.phred import PHRED_TO_P_CAPPED

        seqs, quals = [], []
        for _ in range(64):
            n = int(rng.integers(26, 400))
            # runs of random length so hpol compression is exercised
            s = np.repeat(rng.integers(65, 69, size=n).astype(np.uint8),
                          rng.integers(1, 4, size=n))
            q = rng.integers(33, 105, size=s.size).astype(np.uint8)
            seqs.append(s)
            quals.append(q)
        he, fe = native.read_error_stats_native(seqs, quals, PHRED_TO_P_CAPPED)
        for i in range(len(seqs)):
            assert he[i] == _hpol_error_rate(seqs[i], quals[i]), i
            assert fe[i] == _full_error_rate(quals[i]), i

    def test_chunked_path(self, rng):
        from ngspeciesid.utils.phred import PHRED_TO_P_CAPPED

        seqs = [rng.integers(65, 69, size=50).astype(np.uint8) for _ in range(40)]
        quals = [rng.integers(33, 90, size=50).astype(np.uint8) for _ in range(40)]
        a = native.read_error_stats_native(seqs, quals, PHRED_TO_P_CAPPED)
        import ngspeciesid.native as nat
        # force chunking by monkeying the threshold via tiny slices
        b0, b1 = [], []
        for s in range(0, 40, 7):
            h, f = native.read_error_stats_native(seqs[s:s+7], quals[s:s+7], PHRED_TO_P_CAPPED)
            b0.extend(h.tolist()); b1.extend(f.tolist())
        assert a[0].tolist() == b0 and a[1].tolist() == b1


class TestStage1StatsNative:
    def _mk_reads(self, rng, n, lo=26, hi=400):
        seqs, quals = [], []
        for _ in range(n):
            L = int(rng.integers(lo, hi))
            seqs.append(rng.integers(65, 69, size=L).astype(np.uint8))
            # full phred range incl. sub-cap chars (ASCII 33/34)
            quals.append(rng.integers(33, 75, size=L).astype(np.uint8))
        return seqs, quals

    def test_bit_identical_to_numpy(self, rng):
        from ngspeciesid.ops.score import batch_error_rates, batch_scores
        from ngspeciesid.utils.phred import PHRED_TO_P, PHRED_TO_P_CAPPED
        from ngspeciesid.utils.seqs import hpol_compress_bytes

        k = 13
        seqs, quals = self._mk_reads(rng, 64)
        # low-complexity reads so homopolymer compression has bite
        for _ in range(8):
            L = int(rng.integers(26, 120))
            seqs.append((rng.integers(0, 2, size=L) + 65).astype(np.uint8))
            quals.append(rng.integers(33, 75, size=L).astype(np.uint8))
        sc, er, hl = native.stage1_stats_native(
            seqs, quals, k, PHRED_TO_P_CAPPED, PHRED_TO_P)
        assert np.array_equal(sc, batch_scores(quals, k))
        assert np.array_equal(er, batch_error_rates(quals, capped=False))
        assert hl.tolist() == [hpol_compress_bytes(s).size for s in seqs]

    def test_chunked_path(self, rng):
        from ngspeciesid.ops.score import batch_scores
        from ngspeciesid.utils.phred import PHRED_TO_P, PHRED_TO_P_CAPPED

        k = 9
        seqs, quals = self._mk_reads(rng, 3, lo=18, hi=60)
        seqs, quals = seqs * 6000, quals * 6000  # > one 16384 chunk
        sc, _, _ = native.stage1_stats_native(
            seqs, quals, k, PHRED_TO_P_CAPPED, PHRED_TO_P)
        assert np.array_equal(sc[:3], batch_scores(quals[:3], k))
        assert np.array_equal(sc, np.tile(sc[:3], 6000))


class TestMinimizersNative:
    @pytest.mark.parametrize("k,w", [(13, 20), (15, 50), (5, 9), (3, 3)])
    def test_matches_numpy_engine(self, rng, k, w):
        from ngspeciesid.ops.minimizers import (
            alphabet_ranks, sequence_minimizers)

        rank_of, rank_bits = alphabet_ranks(
            np.frombuffer(b"ACGT", dtype=np.uint8))
        seqs = [rng.integers(65, 69, size=int(n)).astype(np.uint8)
                for n in rng.integers(k, 300, size=60)]
        # short/truncated/empty-kmer windows and low-complexity repeats
        seqs += [rng.integers(65, 67, size=int(n)).astype(np.uint8)
                 for n in rng.integers(k, max(k + 1, 2 * w), size=30)]
        got = native.minimizers_native(seqs, k, w, rank_of, rank_bits)
        for s, (gc, gp) in zip(seqs, got):
            wc, wp = sequence_minimizers(s, k, w, rank_of, rank_bits)
            assert gc.tolist() == wc.tolist()
            assert gp.tolist() == wp.tolist()

    def test_below_k_yields_empty(self):
        from ngspeciesid.ops.minimizers import alphabet_ranks

        rank_of, rank_bits = alphabet_ranks(
            np.frombuffer(b"ACGT", dtype=np.uint8))
        got = native.minimizers_native(
            [np.frombuffer(b"ACGTA", dtype=np.uint8)], 13, 20,
            rank_of, rank_bits)
        assert got[0][0].size == 0 and got[0][1].size == 0


class TestInt32LanePath:
    def test_long_pairs_use_int32_and_match_oracle(self, rng):
        # (n + m + 2) * unit + open + 64 > 16000 forces the int32 rows
        # (fits_int16 gate); long-center RC detection hits this path
        pairs, opens = [], []
        for _ in range(3):
            a = rand_seq(rng, int(rng.integers(1600, 1900)))
            b = mutate(rng, a, 0.1)
            pairs.append((a, b))
            opens.append(int(rng.choice([2, 3])))
        got = native.align_batch_native(pairs, opens)
        want = sg_align_batch(pairs, opens, backend="numpy")
        for g, w in zip(got, want):
            assert g.tolist() == w.tolist()

    def test_long_pairs_banded(self, rng):
        a = rand_seq(rng, 2000)
        b = mutate(rng, a, 0.08)
        got = native.align_batch_native([(a, b)], [3], band=150)
        # banded long pair: same-template, so the band contains the optimal
        # path and the result matches the full DP
        want = native.align_batch_native([(a, b)], [3], band=0)
        assert got[0].tolist() == want[0].tolist()


class TestGuardPage:
    def test_ptr_path_sequence_at_page_end(self, rng):
        # Regression for the tail s2 vector load (sgdp.cpp dp_single_fused_i16):
        # the final 32-lane block used to read up to 30 bytes past the end of
        # s2.  Place each sequence so it ends exactly at a page boundary with
        # a PROT_NONE guard page after it; any overrun read is a SIGSEGV.
        import mmap
        import ctypes

        libc = ctypes.CDLL(None, use_errno=True)
        page = mmap.PAGESIZE

        def guarded_copy(seq):
            buf = mmap.mmap(-1, 2 * page)
            addr = ctypes.addressof(ctypes.c_char.from_buffer(buf))
            assert libc.mprotect(ctypes.c_void_p(addr + page), page, 0) == 0
            start = page - seq.size
            buf[start:page] = seq.tobytes()
            return buf, addr + start

        keep = []
        s1_addr, s2_addr, len1, len2 = [], [], [], []
        pairs = []
        for n in (33, 64, 95, 127, 200, 633):
            a = rand_seq(rng, n)
            b = mutate(rng, a, 0.1)
            for s, addrs, lens in ((a, s1_addr, len1), (b, s2_addr, len2)):
                buf, addr = guarded_copy(s)
                keep.append(buf)
                addrs.append(addr)
                lens.append(s.size)
            pairs.append((a, b))
        B = len(pairs)
        opens = [3] * B
        ks = [13] * B
        mids = [9] * B
        got = native.block_stats_ptr_native(
            np.array(s1_addr, np.int64), np.array(len1, np.int32),
            np.array(s2_addr, np.int64), np.array(len2, np.int32),
            np.array(opens, np.int32), np.array(ks, np.int32),
            np.array(mids, np.int32))
        want = native.block_stats_native(pairs, opens, ks, mids)
        assert got == want
        del keep


def test_hpol_compress_native_matches_numpy(rng):
    from ngspeciesid import native

    if not native.available():
        pytest.skip("native engine unavailable")
    rows = []
    for _ in range(200):
        ln = int(rng.integers(0, 90))
        rows.append(rng.integers(65, 69, size=ln).astype(np.uint8))
    lens = np.array([r.size for r in rows], dtype=np.int64)
    bounds = np.zeros(lens.size + 1, np.int64)
    np.cumsum(lens, out=bounds[1:])
    flat = np.concatenate(rows) if rows else np.zeros(0, np.uint8)
    comp, cb = native.hpol_compress(flat, bounds)
    # oracle: per-row groupby-first
    import itertools
    for i, r in enumerate(rows):
        want = bytes(k for k, _ in itertools.groupby(r.tobytes()))
        got = comp[cb[i]:cb[i + 1]].tobytes()
        assert got == want, f"row {i}"


def test_decide_radix_handles_probe_codes_beyond_base_range(rng):
    """Probe codes are unbounded by the base max the radix shift is derived
    from; an oversized code must fall into the clamped last bucket and
    simply miss (regression: out-of-bounds bidx read -> SIGSEGV)."""
    if not native.available():
        pytest.skip("native engine unavailable")
    n_base = 6000  # above the 4096 threshold so the bucket index is built
    base_codes = np.sort(rng.choice(1_000_000, n_base, replace=False)
                         ).astype(np.int64)
    base_off = np.arange(n_base + 1, dtype=np.int64)
    base_posts = rng.integers(0, 50, n_base).astype(np.int64)
    snap = (base_codes, base_off, base_posts,
            np.zeros(0, np.int64), np.zeros(1, np.int64),
            np.zeros(0, np.int64))
    n_rows = 51
    row_of_id = np.arange(n_rows, dtype=np.int64)
    eidx = np.zeros(n_rows, np.int8)
    hpol_len = np.full(n_rows, 500, np.int64)
    acc_rank = np.arange(n_rows, dtype=np.int64)
    gmax = np.full((15, 15), 3, np.int64)

    def run(extra_code):
        codes = np.concatenate([base_codes[:20],
                                np.array([extra_code], np.int64)])
        pos = np.arange(codes.size, dtype=np.int64) * 10
        roff = np.array([0, codes.size], np.int64)
        return native.decide_wave_native(
            codes, pos, roff,
            np.array([50], np.int64), np.array([50], np.int64),
            snap, row_of_id, eidx, hpol_len, acc_rank, gmax,
            5, 0.8, 0.7, False)

    # huge code (way past 65536 << shift) vs a small non-matching code:
    # identical decisions, and no crash
    d1, ns1, co1, cf1 = run(2_000_000_000)
    d2, ns2, co2, cf2 = run(1_000_001)  # > base max but inside bucket space
    assert d1.tolist() == d2.tolist()
    assert ns1.tolist() == ns2.tolist()
    assert cf1[co1[0]:co1[1]].tolist() == cf2[co2[0]:co2[1]].tolist()
