"""The device stats DP (ops/align_stats.py + native/stats_dp.cu).

The results must reproduce, bit-for-bit, the statistics the host pipeline
computes from a full traceback: match_vector + block_aligned_stats
(reference cluster.py:144-168) and identity_from_moves
(reference consensus.py:129-145) over the alignment of ops/align.py.

The CUDA kernel has no interpret mode.  On the CPU the host side (chunk
planning, pair table, window schedule, trailing-gap finish) runs against
a numpy emulation of the kernel's result rows (tests/stats_emulation.py);
the tests marked ``gpu`` run the kernel itself and skip without a card.
"""

import math

import numpy as np
import pytest

import jax

from ngspeciesid.ops import align as align_mod
from ngspeciesid.ops import align_stats
from ngspeciesid.ops.align import (
    block_aligned_stats,
    identity_from_moves,
    match_vector,
    sg_align_numpy,
)
from ngspeciesid.ops.align_stats import sg_stats_batch_device

from .stats_emulation import emulate_rows


@pytest.fixture(autouse=True)
def _small_launches(monkeypatch):
    # the emulation pays for every padded pair: keep launches small here
    monkeypatch.setattr(align_stats, "MIN_B", 8)


@pytest.fixture()
def emulated_device(monkeypatch):
    """The device backend with the emulation in place of the kernel, for
    batches of any size; returns the widths of the launches made."""
    launched = []

    def rows_fn(pool, table, base, **kw):
        launched.append(kw["W"])
        return emulate_rows(pool, table, base, **kw)

    monkeypatch.setattr(align_mod, "DEVICE_MIN_BATCH", 1)
    monkeypatch.setattr(align_stats, "_default_rows_fn", lambda: rows_fn)
    return launched


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


def oracle(a, b, gap_open, k, match_id):
    moves = sg_align_numpy(a, b, gap_open)
    mv = match_vector(moves, a, b)
    r1, r2 = block_aligned_stats(mv, k, match_id, a.size, b.size)
    ident = identity_from_moves(moves, a, b)
    return r1, r2, ident


def stats(pairs, opens, ks, mids, band=0):
    return sg_stats_batch_device(pairs, opens, ks, mids, band=band,
                                 rows_fn=emulate_rows)


class TestStatsKernelParity:
    def test_random_pairs(self, rng):
        pairs, opens, ks, mids = [], [], [], []
        for _ in range(16):
            pairs.append((rand_seq(rng, int(rng.integers(8, 90))),
                          rand_seq(rng, int(rng.integers(8, 90)))))
            opens.append(int(rng.choice([2, 3, 5])))
            ks.append(int(rng.integers(5, 21)))
            mids.append(int(rng.integers(1, ks[-1] + 1)))
        got = stats(pairs, opens, ks, mids)
        for i, (a, b) in enumerate(pairs):
            want = oracle(a, b, opens[i], ks[i], mids[i])
            assert got[i] == pytest.approx(want, abs=0.0), (i, got[i], want)

    def test_related_pairs(self, rng):
        # realistic case: mutated copies, the fallback's parameterization
        pairs, opens, ks, mids = [], [], [], []
        k = 13
        for _ in range(12):
            a = rand_seq(rng, int(rng.integers(60, 200)))
            b = mutate(rng, a, 0.12)
            if b.size < 5:
                b = rand_seq(rng, 20)
            pairs.append((a, b))
            ers = 0.06 + rng.random() * 0.1
            opens.append(2 if ers > 0.1 else 3)
            ks.append(k)
            mids.append(math.floor((1.0 - ers) * k))
        got = stats(pairs, opens, ks, mids)
        for i, (a, b) in enumerate(pairs):
            want = oracle(a, b, opens[i], ks[i], mids[i])
            assert got[i] == pytest.approx(want, abs=0.0), (i, got[i], want)

    def test_unpacked_high_k(self, rng):
        # k up to 30 (the p-table's top): 30 history bits in one int32
        pairs, opens, ks, mids = [], [], [], []
        for _ in range(6):
            a = rand_seq(rng, int(rng.integers(60, 140)))
            pairs.append((a, mutate(rng, a, 0.08)))
            opens.append(3)
            ks.append(int(rng.choice([26, 28, 30])))
            mids.append(int(rng.integers(5, 20)))
        got = stats(pairs, opens, ks, mids)
        for i, (a, b) in enumerate(pairs):
            want = oracle(a, b, opens[i], ks[i], mids[i])
            assert got[i] == pytest.approx(want, abs=0.0)

    def test_terminal_gap_windows(self, rng):
        # long unaligned suffixes/prefixes: the host tail fold must count
        # windows that straddle the aligned core and trailing gap columns
        a = rand_seq(rng, 150)
        core = a[40:90].copy()
        b = np.concatenate([rand_seq(rng, 30), core, rand_seq(rng, 60)])
        pairs = [(a, b), (b, a)]
        opens, ks, mids = [3, 3], [13, 13], [11, 11]
        got = stats(pairs, opens, ks, mids)
        for i, (s1, s2) in enumerate(pairs):
            want = oracle(s1, s2, opens[i], ks[i], mids[i])
            assert got[i] == pytest.approx(want, abs=0.0)

    def test_negative_match_id(self, rng):
        # err_sum > 1 makes match_id <= 0: every window passes, including
        # all-gap windows in leading/trailing terminal gaps
        a = rand_seq(rng, 12)
        b = rand_seq(rng, 120)
        got = stats([(a, b)], [2], [13], [-3])
        want = oracle(a, b, 2, 13, -3)
        assert got[0] == pytest.approx(want, abs=0.0)

    def test_short_alignment_below_k(self, rng):
        # total columns < k: ratios are defined as 0 (cluster.py:146)
        a = rand_seq(rng, 5)
        b = rand_seq(rng, 6)
        got = stats([(a, b)], [5], [20], [10])
        want = oracle(a, b, 5, 20, 10)
        assert got[0] == pytest.approx(want, abs=0.0)
        assert got[0][0] == 0.0 and got[0][1] == 0.0

    def test_identity_wrapper(self, rng, emulated_device):
        pairs = [(rand_seq(rng, 80), rand_seq(rng, 70)) for _ in range(5)]
        got = align_mod.identity_batch(pairs, [3] * 5, backend="device")
        for i, (a, b) in enumerate(pairs):
            moves = sg_align_numpy(a, b, 3)
            assert got[i] == pytest.approx(identity_from_moves(moves, a, b), abs=0.0)

    def test_block_stats_wrapper(self, rng, emulated_device):
        pairs = [(rand_seq(rng, 80), mutate(rng, rand_seq(rng, 80), 0.1))
                 for _ in range(4)]
        got = align_mod.block_stats_batch(pairs, [4] * 4, [13] * 4, [11] * 4,
                                          backend="device")
        for i, (a, b) in enumerate(pairs):
            r1, r2, _ = oracle(a, b, 4, 13, 11)
            assert got[i] == pytest.approx((r1, r2), abs=0.0)


class TestBandedParity:
    """band > 0: the rolling-window DP must equal the native banded engine
    whenever the optimal path stays inside the band (the production
    contract: same-template amplicon pairs).  Both then also equal the full
    DP."""

    def _pairs(self, rng, n_pairs=12, lo=300, hi=900, rate=0.12):
        pairs, opens, ks, mids = [], [], [], []
        for _ in range(n_pairs):
            a = rand_seq(rng, int(rng.integers(lo, hi)))
            b = mutate(rng, a, rate)
            pairs.append((a, b))
            opens.append(int(rng.choice([2, 3, 4, 5])))
            ks.append(int(rng.choice([13, 15, 20])))
            mids.append(int(rng.integers(5, 15)))
        return pairs, opens, ks, mids

    def test_banded_equals_full_and_native(self, rng):
        from ngspeciesid import native

        pairs, opens, ks, mids = self._pairs(rng)
        got = stats(pairs, opens, ks, mids, band=150)
        full = [oracle(a, b, o, k, m)
                for (a, b), o, k, m in zip(pairs, opens, ks, mids)]
        for g, w in zip(got, full):
            assert g == pytest.approx(w, abs=0)
        if native.available():
            nat = native.block_stats_native(pairs, opens, ks, mids, band=150)
            for g, w in zip(got, nat):
                assert (g[0], g[1]) == pytest.approx(w, abs=0)

    def test_banded_mixed_length_chunking(self, rng):
        # wide length spread in one request: the chunk planner must keep
        # every pair's band covered by its chunk's shared window
        pairs, opens, ks, mids = [], [], [], []
        for lo, hi in ((80, 150), (300, 500), (600, 1000)):
            p, o, kk, mm = self._pairs(rng, n_pairs=5, lo=lo, hi=hi)
            pairs += p; opens += o; ks += kk; mids += mm
        got = stats(pairs, opens, ks, mids, band=150)
        full = [oracle(a, b, o, k, m)
                for (a, b), o, k, m in zip(pairs, opens, ks, mids)]
        for g, w in zip(got, full):
            assert g == pytest.approx(w, abs=0)

    def test_window_schedule_covers_band(self, rng):
        from ngspeciesid.ops.align_stats import _window_schedule

        for _ in range(20):
            B = int(rng.integers(1, 9))
            len1 = rng.integers(50, 1200, size=B)
            len2 = rng.integers(50, 1200, size=B)
            n = int(len1.max()); m = int(len2.max())
            band = int(rng.choice([50, 150, 300]))
            base, W = _window_schedule(len1, len2, n, m, band)
            assert base.shape == (n + m + 1,)
            # slope and monotonicity invariants consumed by the kernel
            d = np.diff(base.astype(np.int64))
            assert (d >= 0).all() and (d <= 1).all()
            if W >= n + 1:
                continue
            # every interior in-band cell of every pair sits in the window
            for b in range(B):
                nb, mb = int(len1[b]), int(len2[b])
                i = np.arange(1, nb + 1, dtype=np.int64)[:, None]
                j = np.arange(1, mb + 1, dtype=np.int64)[None, :]
                inband = ((j - band) * nb <= i * mb) & \
                         (i * mb <= (j + band + 1) * nb - 1)
                ii, jj = np.nonzero(inband)
                iv, dv = ii + 1, ii + 1 + jj + 1
                lane = iv - base[dv]
                assert (lane >= 0).all() and (lane < W).all()


class TestTrailingGapFinish:
    """_gather_chunk folds the trailing terminal gaps into the window count
    on the host.  Pairs whose optimal alignment ends before one sequence
    does, at every k the p-table covers, banded and full."""

    @pytest.mark.parametrize("band", [0, 150])
    @pytest.mark.parametrize("k", [5, 13, 20, 30])
    @pytest.mark.parametrize("tail", [3, 40])
    def test_tail_fold_matches_oracle(self, rng, k, band, tail):
        pairs = []
        for lead in (0, 7):
            a = rand_seq(rng, 120)
            b = np.concatenate([rand_seq(rng, lead), mutate(rng, a, 0.06),
                                rand_seq(rng, tail)])
            pairs += [(a, b), (b, a)]
        n = len(pairs)
        mids = [int(0.8 * k)] * (n - 1) + [0]
        got = stats(pairs, [3] * n, [k] * n, mids, band=band)
        for (a, b), g, mid in zip(pairs, got, mids):
            assert g == pytest.approx(oracle(a, b, 3, k, mid), abs=0.0)


def _cards(monkeypatch, capability="9.0", n=1):
    """Make JAX report ``n`` GPUs of ``capability`` as the default backend."""
    import types

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(jax, "local_devices", lambda: [
        types.SimpleNamespace(platform="gpu", compute_capability=capability)
        for _ in range(n)])


class TestDispatch:
    def test_gpu_backend_picks_device(self, monkeypatch):
        monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
        _cards(monkeypatch)
        assert align_mod.device_dp_available()
        assert align_mod.stats_backend_default() == "device"

    @pytest.mark.parametrize("capability", ["8.0", "8.9", "10.0"])
    def test_other_gpus_pick_host_engine(self, monkeypatch, capability):
        # the library holds sm_90a code only: other cards keep the host engine
        from ngspeciesid import native

        monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
        _cards(monkeypatch, capability)
        assert not align_mod.device_dp_available()
        want = "native" if native.available() else "host"
        assert align_mod.stats_backend_default() == want

    def test_cpu_backend_picks_host_engine(self, monkeypatch):
        from ngspeciesid import native

        monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
        assert not align_mod.device_dp_available()
        want = "native" if native.available() else "host"
        assert align_mod.stats_backend_default() == want

    @pytest.mark.parametrize("name", ["native", "device", "host"])
    def test_env_override(self, monkeypatch, name):
        _cards(monkeypatch)
        monkeypatch.setenv("NGSID_STATS_BACKEND", name.upper())
        assert align_mod.stats_backend_default() == name

    @pytest.mark.parametrize("n_pairs", [1, 255, 256, 4096])
    def test_small_device_batches_run_native(self, rng, n_pairs):
        from ngspeciesid import native

        seqs = [rand_seq(rng, 100), rand_seq(rng, 90)]
        chunks, rest, rest_be = align_mod.plan_stats(
            seqs, [0] * n_pairs, [1] * n_pairs, band=150, backend="device")
        small = n_pairs < align_mod.DEVICE_MIN_BATCH and native.available()
        assert rest_be == ("native" if native.available() else "host")
        on_device = sorted(i for sl, _ in chunks for i in sl)
        assert on_device == ([] if small else list(range(n_pairs)))
        assert rest == (list(range(n_pairs)) if small else [])

    @pytest.mark.parametrize("backend", ["native", "host"])
    def test_host_backends_plan_no_launch(self, backend):
        seqs = [np.zeros(10, np.uint8)] * 2
        assert align_mod.plan_stats(seqs, [0] * 500, [1] * 500,
                                    backend=backend) == (
            [], list(range(500)), backend)

    def test_device_library_failure_raises_on_gpu(self, rng, monkeypatch,
                                                  tmp_path):
        from ngspeciesid.ops import stats_cuda

        def no_nvcc():
            raise RuntimeError("nvcc not found")

        _cards(monkeypatch)
        monkeypatch.delenv("NGSID_STATS_BACKEND", raising=False)
        monkeypatch.setattr(stats_cuda, "_registered", False)
        monkeypatch.setattr(stats_cuda, "_BUILD", str(tmp_path))
        monkeypatch.setattr(stats_cuda, "_SO", str(tmp_path / "missing.so"))
        monkeypatch.setattr(stats_cuda, "_nvcc", no_nvcc)
        pairs = [(rand_seq(rng, 30), rand_seq(rng, 30))] * 300
        with pytest.raises(RuntimeError, match="nvcc"):
            align_mod.block_stats_batch(pairs, [3] * 300, [13] * 300,
                                        [10] * 300, band=150)

    def test_build_failure_reports_compiler(self, monkeypatch, tmp_path):
        from ngspeciesid.ops import stats_cuda

        monkeypatch.setattr(stats_cuda, "_BUILD", str(tmp_path))
        monkeypatch.setattr(stats_cuda, "_SO", str(tmp_path / "lib.so"))
        monkeypatch.setattr(stats_cuda, "_nvcc", lambda: "false")
        with pytest.raises(RuntimeError, match="building the device stats DP"):
            stats_cuda.build()


class TestChunkPlanning:
    def test_chunks_bounded_and_bucketed(self, rng, monkeypatch):
        from ngspeciesid.ops.align import _bucket_width

        monkeypatch.setattr(align_stats, "MAX_B", 8)
        seqs = [rand_seq(rng, int(rng.integers(20, 1500))) for _ in range(60)]
        rows1 = [int(x) for x in rng.integers(0, 60, size=50)]
        rows2 = [int(x) for x in rng.integers(0, 60, size=50)]
        chunks = align_stats._plan_chunks(seqs, rows1, rows2)
        assert sorted(i for c in chunks for i in c) == list(range(50))
        for c in chunks:
            assert 1 <= len(c) <= 8
            keys = {(_bucket_width(seqs[rows1[i]].size),
                     _bucket_width(seqs[rows2[i]].size)) for i in c}
            assert len(keys) == 1
            tot = [seqs[rows1[i]].size + seqs[rows2[i]].size for i in c]
            assert tot == sorted(tot, reverse=True)

    @pytest.mark.parametrize("B,want", [
        (1, 128), (128, 128), (129, 256), (3000, 4096), (4096, 4096)])
    def test_padded_batch(self, monkeypatch, B, want):
        monkeypatch.setattr(align_stats, "MIN_B", 128)
        assert align_stats._padded_batch(B) == want

    def test_pair_table_padding(self):
        ar = np.array
        t = align_stats._pair_table(ar([700, 650]), ar([690, 720]), ar([3, 4]),
                                    ar([13, 15]), ar([11, 12]), ar([0, 700]),
                                    ar([1350, 2040]), 8)
        assert t.shape == (8, align_stats.TABLE_COLS) and t.dtype == np.int32
        assert t[:2].tolist() == [[700, 690, 3, 13, 11, 0, 1350, 0],
                                  [650, 720, 4, 15, 12, 700, 2040, 0]]
        # padding rows are cheap 1x1 pairs at offset 0
        assert (t[2:] == [1, 1, 5, 13, 0, 0, 0, 0]).all()

    @pytest.mark.parametrize("n,m,W,fits", [
        (1024, 1024, 256, True), (4096, 4096, 4096, True),
        (4096, 4096, 4224, False), (40000, 30000, 256, False),
        # sequences above the default 48 KB of shared memory per block
        (23040, 23040, 384, True), (32768, 32767, 384, True),
        (32768, 32768, 384, False)])
    def test_fits_device(self, n, m, W, fits):
        assert align_stats.fits_device(n, m, W) is fits

    @pytest.mark.parametrize("W,lanes", [
        (128, 1), (256, 2), (512, 4), (1152, 8), (4096, 8)])
    def test_lanes_per_thread(self, W, lanes):
        from ngspeciesid.ops.stats_cuda import lanes_per_thread

        assert lanes_per_thread(W) == lanes
        assert -(-W // lanes) <= 512       # the kernel's block limit

    @pytest.mark.parametrize("max_w,launched", [(128, [128]), (64, [])])
    def test_wide_chunks_run_on_host_engine(self, rng, monkeypatch,
                                            emulated_device, max_w, launched):
        # band 0 makes the window the whole matrix: with MAX_W = 128 the
        # short pairs fit one block and the long ones go to the host; with
        # 64 every pair goes there, planned out of request order
        monkeypatch.setattr(align_stats, "MAX_W", max_w)
        pairs = [(rand_seq(rng, 300), rand_seq(rng, 280)) for _ in range(2)]
        pairs += [(rand_seq(rng, 60), rand_seq(rng, 50)) for _ in range(3)]
        got = align_mod.block_stats_batch(pairs, [3] * 5, [13] * 5, [9] * 5,
                                          backend="device")
        assert emulated_device == launched
        for (a, b), g in zip(pairs, got):
            assert g == pytest.approx(oracle(a, b, 3, 13, 9)[:2], abs=0.0)

    def test_pool_device_refuses_wide_chunks(self, rng, monkeypatch):
        def no_launch(*a, **kw):
            raise AssertionError("a chunk too wide for the kernel launched")

        monkeypatch.setattr(align_stats, "MAX_W", 64)
        pairs = [(rand_seq(rng, 90), rand_seq(rng, 80)) for _ in range(3)]
        with pytest.raises(ValueError, match="too wide"):
            sg_stats_batch_device(pairs, [3] * 3, [13] * 3, [9] * 3,
                                  rows_fn=no_launch)

    def test_pool_rows_shares_repeated_arrays(self, rng):
        a, b, c = (rand_seq(rng, 20) for _ in range(3))
        seqs, rows1, rows2 = align_stats.pool_rows([(a, b), (b, a), (a, c)])
        assert [id(x) for x in seqs] == [id(a), id(b), id(c)]
        assert (rows1, rows2) == ([0, 1, 0], [1, 0, 2])

    @pytest.mark.parametrize("band", [0, 150])
    def test_identity_batch_mixes_device_and_host(self, rng, monkeypatch,
                                                  emulated_device, band):
        monkeypatch.setattr(align_stats, "MAX_W", 128)
        pairs = [(rand_seq(rng, int(rng.integers(40, 64))),
                  rand_seq(rng, int(rng.integers(40, 64))))
                 for _ in range(4)]
        pairs += [(rand_seq(rng, 400), rand_seq(rng, 380))]
        got = align_mod.identity_batch(pairs, [3] * 5, band=band,
                                       backend="device")
        assert emulated_device == [128]       # the long pair ran on the host
        for (a, b), g in zip(pairs, got):
            moves = sg_align_numpy(a, b, 3)
            assert g == pytest.approx(identity_from_moves(moves, a, b),
                                      abs=0.0)


class TestDevicePool:
    def test_growth_boundary_keeps_offsets_valid(self, rng):
        # regression: the ladder-PADDED append chunk must fit capacity —
        # dynamic_update_slice clamps an out-of-range start, which would
        # land the chunk at a wrong offset and silently corrupt residency
        from ngspeciesid.ops.align_stats import DevicePool

        pool = DevicePool()
        pool.cap = 1 << 17          # 128 KB, so growth happens immediately
        rows = []
        for _ in range(40):
            rows.append(rng.integers(65, 69, size=int(
                rng.integers(20_000, 70_000))).astype(np.uint8))
            pool.ensure(rows[-1:])
        dev = np.asarray(pool.dev)
        for r in rows:
            off = pool.offset(r)
            assert np.array_equal(dev[off:off + r.size], r), \
                "resident bytes diverge from the host row"

    def test_wrap_reuploads_current_request(self, rng, monkeypatch):
        from ngspeciesid.ops.align_stats import DevicePool

        monkeypatch.setattr(DevicePool, "CAP_MAX", 1 << 19)    # 512 KB
        pool = DevicePool()
        pool.cap = 1 << 17
        a = rng.integers(65, 69, size=100_000).astype(np.uint8)
        pool.ensure([a])
        # force a wrap with a request that includes the resident row
        b = rng.integers(65, 69, size=400_000).astype(np.uint8)
        pool.ensure([a, b])
        dev = np.asarray(pool.dev)
        for r in (a, b):
            off = pool.offset(r)
            assert np.array_equal(dev[off:off + r.size], r)


@pytest.fixture()
def card():
    if jax.default_backend() != "gpu":
        pytest.skip("needs the CUDA card (run by chip_smoke.py)")


@pytest.mark.gpu
class TestOnCard:
    """The CUDA kernel itself, compiled for the card."""

    def test_kernel_matches_emulation(self, rng, card):
        from ngspeciesid.ops.stats_cuda import stats_rows

        pairs, opens, ks, mids = TestBandedParity()._pairs(rng, n_pairs=24)
        for band in (0, 150):
            got = sg_stats_batch_device(pairs, opens, ks, mids, band=band,
                                        rows_fn=stats_rows)
            assert got == stats(pairs, opens, ks, mids, band=band)

    @pytest.mark.parametrize("length", [22000, 23000, 32000])
    def test_long_pairs_past_default_shared_memory(self, rng, card, length):
        # n + m bucket widths of 44,032 / 46,080 / 64,512 bytes: below and
        # above the 48 KB a block gets without opting into more
        from ngspeciesid import native
        from ngspeciesid.ops.stats_cuda import stats_rows

        pairs = []
        for _ in range(2):
            a = rand_seq(rng, length)
            pairs.append((a, mutate(rng, a, 0.05)))
        opens, ks, mids = [3, 3], [13, 15], [11, 12]
        got = sg_stats_batch_device(pairs, opens, ks, mids, band=150,
                                    rows_fn=stats_rows)
        nat = native.block_stats_native(pairs, opens, ks, mids, band=150)
        assert [g[:2] for g in got] == nat

    def test_kernel_matches_oracle(self, rng, card):
        from ngspeciesid.ops.stats_cuda import stats_rows

        pairs = [(rand_seq(rng, 150), rand_seq(rng, 130)) for _ in range(6)]
        got = sg_stats_batch_device(pairs, [3] * 6, [13] * 6, [10] * 6,
                                    rows_fn=stats_rows)
        for (a, b), g in zip(pairs, got):
            assert g == pytest.approx(oracle(a, b, 3, 13, 10), abs=0.0)
