"""Device stats DP: banded semi-global Gotoh alignment that returns only the
path statistics its consumers need.

The consumers of the alignment never need the alignment itself, only two
derived statistics of the optimal path (SURVEY.md N1):

  * cluster fallback: rolling-window aligned-region ratios
    (reference cluster.py:144-169), i.e. the number of k-column windows of
    the alignment with >= match_id matching columns, divided by each
    sequence length;
  * RC/dup detection: column identity = matches / alignment columns
    (reference consensus.py:129-145).

Every cell's move choice is a deterministic function of the cell (the same
tie-break the traceback uses: diag > up > left, gap-open on >=), so the
statistics of the optimal path are propagated FORWARD next to the scores.
Per layer (H, E, F) and cell the DP carries four int32 fields:

    score | hist (last-k match bits) | wcount (windows with >= match_id
    matches so far) | mcount << 16 | colcount

The matches inside the current window are ``popcount(hist)``.  Each DP
transition consumes exactly one alignment column (match bit for diagonal
moves, 0 for gap columns), so the update is a shift-register step.  Boundary
cells restart a path with colcount = i + j leading terminal-gap columns.
Trailing terminal gaps are applied on the host (:func:`_gather_chunk`) from
one 16-int row per pair, which is all that leaves the device.

Layout: the DP sweeps anti-diagonals over a rolling window.  Lane ``l`` of
diagonal ``dd`` holds cell ``i = base[dd] + l`` (``j = dd - i``), where
``base`` is a host-computed, per-diagonal window origin covering every
pair's band (:func:`_window_schedule`, the native engine's diagonal-scaled
band: ``(j-band)*n <= i*m <= (j+band+1)*n - 1``).  Work scales with
band*(n+m), not n*m; band=0 makes the window the full matrix (exact full
DP).  Out-of-band cells are unreachable.  The native banded engine instead
lets its overrun lanes read stale values at the band's top edge, so the two
backends can differ when the optimal path leaves the band; parity holds
whenever it stays inside (the production contract for amplicon pairs).

With band=0 the results are bit-identical to match_vector +
block_aligned_stats + identity_from_moves over the traceback of
ops/align.py.  Requires k <= 30 (history bits in int32).

The kernel itself is CUDA (``native/stats_dp.cu``, called through
``jax.ffi``; see :mod:`ngspeciesid.ops.stats_cuda`).  This module holds
what surrounds it: the resident sequence pool, chunk planning, the window
schedule, the pair table and the host-side finish.
"""

from __future__ import annotations

import functools
from typing import List, Optional, Sequence, Tuple

import numpy as np

import jax
import jax.numpy as jnp

from .align import _bucket_width

#: ints per pair in the kernel's result row: the last-row endpoint tracker
#: then the last-column one, each (score, coord, hist, wsum, wcount, mcount,
#: colcount, diagonal)
ROW_COLS = 16
#: pair-table columns: len1, len2, gap_open, k, match_id, off1, off2, unused
TABLE_COLS = 8
MAX_K = 30          # history bits must fit int32
#: widest window one thread block holds (512 threads x 8 lanes)
MAX_W = 4096
#: mcount and colcount share one int32 (16 bits each); this also bounds the
#: two sequences the kernel holds in shared memory to 64 KB per block, more
#: than the default 48 KB: the kernel opts into the larger limit at launch
MAX_NM = (1 << 16) - 1


class DevicePool:
    """Device-resident deduplicated sequence pool.

    Each distinct host row crosses to the device ONCE for the lifetime of
    the pool and stays resident across launches, waves and sub-rounds;
    launches reference rows by (offset, length) and the kernel reads them
    in place.  Appends ship only rows not yet resident, padded to a coarse
    size ladder so the transfer shapes stay compile-bounded; capacity grows
    on a power-of-4 ladder via an on-device copy (offsets never move).  The
    pool holds a strong reference to every uploaded host row, so
    id()-keying is safe.
    """

    APPEND_MIN = 1 << 16          # 64 KB append granularity
    CAP_MIN = 1 << 22             # 4 MB initial capacity
    CAP_MAX = 1 << 30             # 1 GB: int32 offsets, bounded memory

    def __init__(self) -> None:
        self._off: dict = {}      # id(row) -> byte offset
        self._keep: dict = {}     # id(row) -> row (pin host arrays)
        self._used = 0
        self.cap = self.CAP_MIN
        self.dev = None           # lazily-allocated jnp.uint8 (cap,)

    # no donation: a launch still in flight may hold the old buffer
    @staticmethod
    @jax.jit
    def _append(pool, chunk, off):
        return jax.lax.dynamic_update_slice(pool, chunk, (off,))

    @staticmethod
    @functools.partial(jax.jit, static_argnames=("newcap",))
    def _grow(pool, newcap: int):
        out = jnp.zeros((newcap,), jnp.uint8)
        return jax.lax.dynamic_update_slice(out, pool, (0,))

    def reset(self) -> None:
        self._off.clear()
        self._keep.clear()
        self._used = 0
        self.cap = self.CAP_MIN
        self.dev = None

    def ensure(self, rows: Sequence[np.ndarray]) -> None:
        """Upload any of ``rows`` not yet resident (one fused transfer)."""
        missing = []
        size = 0
        seen = set()
        for r in rows:
            key = id(r)
            if key not in self._off and key not in seen:
                seen.add(key)
                missing.append(r)
                size += r.size
        if self.dev is None:
            self.dev = jnp.zeros((self.cap,), jnp.uint8)
        if not missing:
            return
        if size > self.CAP_MAX:
            raise ValueError(
                f"single pool request of {size} bytes exceeds the "
                f"device pool capacity cap ({self.CAP_MAX})")
        pad = self.APPEND_MIN
        while pad < size:
            pad *= 4                  # transfer-shape ladder
        pad = min(pad, self.CAP_MAX)  # ladder may overshoot the cap
        # capacity must cover the PADDED chunk, not just the payload:
        # dynamic_update_slice CLAMPS an out-of-range start, which would
        # land the chunk at a wrong offset and silently corrupt residency
        if self._used + pad > self.CAP_MAX:
            # wrap: drop residency and start over (old offsets invalid, so
            # every caller must take offsets AFTER ensure(), never cache);
            # re-ensure the FULL request: rows of this call that were
            # resident before the wrap must be re-uploaded too
            self.reset()
            return self.ensure(rows)
        while self._used + pad > self.cap:
            newcap = min(self.cap * 4, self.CAP_MAX)
            self.dev = DevicePool._grow(self.dev, newcap=newcap)
            self.cap = newcap
        chunk = np.zeros(pad, np.uint8)
        off = self._used
        woff = 0                      # offset within the staged chunk
        for r in missing:
            chunk[woff: woff + r.size] = r
            self._off[id(r)] = off + woff
            self._keep[id(r)] = r
            woff += r.size
        self.dev = DevicePool._append(self.dev, jnp.asarray(chunk),
                                      jnp.int32(self._used))
        self._used = off + woff

    def offset(self, row: np.ndarray) -> int:
        return self._off[id(row)]


_DEVICE_POOL: Optional[DevicePool] = None

#: pairs and launches the device DP has run in this process
COUNTERS = {"pairs": 0, "launches": 0}


def _device_pool() -> DevicePool:
    global _DEVICE_POOL
    if _DEVICE_POOL is None:
        _DEVICE_POOL = DevicePool()
    return _DEVICE_POOL


def _popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized 32-bit popcount (SWAR)."""
    x = x.astype(np.uint32)
    x = x - ((x >> 1) & np.uint32(0x55555555))
    x = (x & np.uint32(0x33333333)) + ((x >> 2) & np.uint32(0x33333333))
    x = (x + (x >> 4)) & np.uint32(0x0F0F0F0F)
    return ((x * np.uint32(0x01010101)) >> 24).astype(np.int64)


_SCHED_CACHE: dict = {}


def _window_schedule(len1: np.ndarray, len2: np.ndarray,
                     n: int, m: int, band: int) -> Tuple[np.ndarray, int]:
    """Per-diagonal window origin ``base`` (shape (n+m+1,)) and width ``W``
    covering every pair's banded cell set (plus the boundary rows/columns
    each pair's band touches).  base is non-decreasing with slope <= 1, so
    the kernel's frame shifts are by {0, 1} lanes ({0..2} across two
    diagonals).

    Memoized on the (min/max length, bucket, band) envelope: the hull of
    the envelope's two extreme pairs contains every pair hull, so reusing
    it preserves coverage while collapsing the per-launch recompute."""
    key = (int(len1.min()), int(len1.max()), int(len2.min()),
           int(len2.max()), n, m, band)
    hit = _SCHED_CACHE.get(key)
    if hit is not None:
        return hit
    out = _window_schedule_raw(n, m, band, key)
    if len(_SCHED_CACHE) > 4096:
        _SCHED_CACHE.clear()
    _SCHED_CACHE[key] = out
    return out


def _window_schedule_raw(n, m, band, key) -> Tuple[np.ndarray, int]:
    # Envelope: the hull formulas below are monotone in n_b and in m_b, so
    # the four corner combinations of (min/max len1, min/max len2) bound
    # every pair pointwise per diagonal.  No dead-diagonal exclusion: a
    # corner whose matrix has ended keeps contributing its (clipped,
    # nondecreasing) hull values, which can only lower base / raise W,
    # both coverage-safe.  (An exclusion would be UNsafe: dropping a short
    # corner at large dd can raise the min above a live mid-length pair.)
    l1a, l1b = key[0], key[1]
    l2a, l2b = key[2], key[3]
    len1 = np.array([l1a, l1a, l1b, l1b], np.int64)
    len2 = np.array([l2a, l2b, l2a, l2b], np.int64)
    D = n + m
    W_full = -(-(n + 1) // 128) * 128
    if band <= 0:
        return np.zeros(D + 1, np.int32), W_full
    dd = np.arange(D + 1, dtype=np.int64)[:, None]
    n_b = len1[None, :]
    m_b = len2[None, :]
    tot = n_b + m_b
    # interior band rows on diagonal dd (from the multiplicative band test)
    lo_int = -(-(np.maximum(dd - band, 0) * n_b) // tot)    # ceil
    hi_int = ((dd + band + 1) * n_b - 1) // tot
    lo_int = np.maximum(lo_int, np.maximum(1, dd - m_b))
    hi_int = np.minimum(hi_int, n_b)
    hi_int = np.maximum(hi_int, 0)
    # boundary i=0 (cell (0, dd)): consumed by in-band cells at i=1, which
    # exist only while dd <= band + len2/len1 (+ slack)
    lo = np.where(dd <= np.minimum(m_b, band + m_b // n_b + 2), 0, lo_int)
    # boundary j=0 (cell (dd, 0)): consumed by in-band cells at j=1, which
    # exist only while i <= (band+1)*len1/len2 (+ slack)
    hi = np.where(dd <= np.minimum(n_b, (band + 1) * n_b // m_b + 2),
                  np.minimum(dd, n_b), hi_int)
    hi = np.minimum(hi, np.minimum(dd, n_b))
    need_lo = np.minimum.reduce(np.clip(lo, 0, n), axis=1)
    need_hi = np.maximum.reduce(hi, axis=1)
    base = np.clip(need_lo, 0, n)
    # slope <= 1: cap upward jumps (a short pair leaving the hull can make
    # need_lo jump) by base[d] <- min_{e<=d}(need_lo[e] + (d - e)); lowering
    # a later base only widens coverage, and since need_lo is nondecreasing
    # the result stays nondecreasing (W is computed afterwards)
    idx = np.arange(base.size, dtype=np.int64)
    base = np.minimum.accumulate(base - idx) + idx
    W_need = int(np.max(np.maximum(need_hi - base, 0)) + 1)
    W = max(128, -(-W_need // 128) * 128)
    if W >= W_full:
        return np.zeros(D + 1, np.int32), W_full  # window = full matrix
    return base.astype(np.int32), W


#: Pairs per device launch, the upper rung of a power-of-two batch ladder
#: that bounds the compiled shapes; larger requests split into several
#: launches.  On an H100 a call's cost per 700 bp pair at band 150 falls
#: from ~11 us at 512 pairs to ~9 us at 1,024 and ~8.5 us at 4,096, so
#: larger launches gain little (launch-cost ladder in CHANGES.md).
MAX_B = 4096
#: Smallest padded batch: remainder chunks share one compiled shape.
MIN_B = 128


def _plan_chunks(seqs, rows1, rows2) -> List[List[int]]:
    """Split request indices into device chunks: bounded size and coarse
    length buckets (compile reuse; banded windows also stay near 2*band
    wide when pair lengths are comparable).  Within a bucket, pairs are
    graded by total length descending, so the pairs of one chunk have
    similar sweep lengths."""
    def bucket(i):
        return (_bucket_width(seqs[rows1[i]].size),
                _bucket_width(seqs[rows2[i]].size))

    order = sorted(range(len(rows1)),
                   key=lambda i: bucket(i) + (
                       -(seqs[rows1[i]].size + seqs[rows2[i]].size),))
    chunks: List[List[int]] = []
    cur: List[int] = []
    cur_key = None
    for i in order:
        key = bucket(i)
        if cur and (key != cur_key or len(cur) >= MAX_B):
            chunks.append(cur)
            cur = []
        cur_key = key
        cur.append(i)
    if cur:
        chunks.append(cur)
    return chunks


def _padded_batch(B: int) -> int:
    """Launch batch for ``B`` pairs: the next power of two, at least MIN_B."""
    return max(MIN_B, 1 << (B - 1).bit_length())


def _pair_table(len1, len2, gap_opens, ks, match_ids, off1, off2,
                Bp: int) -> np.ndarray:
    """(Bp, TABLE_COLS) int32 pair table; padding rows are 1x1 pairs."""
    B = len1.size
    pm = np.zeros((Bp, TABLE_COLS), np.int32)
    pm[:, 0:2] = 1
    pm[:, 2] = 5
    pm[:, 3] = 13
    pm[:B, 0] = len1
    pm[:B, 1] = len2
    pm[:B, 2] = gap_opens
    pm[:B, 3] = ks
    pm[:B, 4] = match_ids
    pm[:B, 5] = off1
    pm[:B, 6] = off2
    return pm


def fits_device(n: int, m: int, W: int) -> bool:
    """Whether an ``n`` x ``m`` bucket with window width ``W`` fits one
    kernel block."""
    return n + m <= MAX_NM and W <= MAX_W


def _chunk_shape(seqs, r1, r2, band):
    """(len1, len2, n, m, base, W) of one chunk."""
    B = len(r1)
    len1 = np.fromiter((seqs[r].size for r in r1), np.int64, count=B)
    len2 = np.fromiter((seqs[r].size for r in r2), np.int64, count=B)
    n = _bucket_width(int(len1.max()))
    m = _bucket_width(int(len2.max()))
    base, W = _window_schedule(len1, len2, n, m, band)
    return len1, len2, n, m, base, W


def _launch_chunk(seqs, r1, r2, gap_opens, ks, match_ids,
                  match, mismatch, gap_ext, band, rows_fn, shape):
    B = len(r1)
    len1, len2, n, m, base, W = shape
    # resident pool: rows already on device cost nothing; new rows ship once
    pool = _device_pool()
    pool.ensure([seqs[r] for r in dict.fromkeys(list(r1) + list(r2))])
    off1 = np.fromiter((pool.offset(seqs[r]) for r in r1), np.int64, count=B)
    off2 = np.fromiter((pool.offset(seqs[r]) for r in r2), np.int64, count=B)
    table = _pair_table(len1, len2, np.asarray(gap_opens), np.asarray(ks),
                        np.asarray(match_ids), off1, off2, _padded_batch(B))
    COUNTERS["pairs"] += B
    COUNTERS["launches"] += 1
    rows = rows_fn(pool.dev, jnp.asarray(table), jnp.asarray(base),
                   W=W, n=n, m=m, band=band, match=match, mismatch=mismatch,
                   gap_ext=gap_ext)
    return rows, len1, len2, np.asarray(ks, np.int64), \
        np.asarray(match_ids, np.int64), band


def _gather_chunk(best_dev, len1, len2, karr, midarr, band):
    """Finish the kernel's per-pair result rows on the host: pick the
    endpoint, fold in the trailing terminal gaps, divide."""
    B = len1.size
    best = np.asarray(best_dev)[:B]

    use_row = best[:, 0] >= best[:, 8]
    side = np.where(use_row[:, None], best[:, 0:8], best[:, 8:16])
    if band > 0:
        # native banded endpoint scans fall back to the empty alignment
        # (H[n][0] = 0 / col_best init 0) when every banded endpoint is
        # negative; synthesize the same endpoint here
        neg = side[:, 0] < 0
        if neg.any():
            use_row = np.where(neg, True, use_row)
            empty = np.zeros_like(side)
            empty[:, 6] = len1                        # cc = i + j at (n, 0)
            empty[:, 4] = np.where(midarr <= 0,
                                   np.maximum(len1 - karr + 1, 0), 0)
            empty[:, 1] = 0
            side = np.where(neg[:, None], empty, side)
    end_i = np.where(use_row, len1, side[:, 1])
    end_j = np.where(use_row, side[:, 1], len2)
    hist = side[:, 2].astype(np.int64)
    wc = side[:, 4].astype(np.int64)
    mc = side[:, 5].astype(np.int64)
    cc = side[:, 6].astype(np.int64)

    # trailing terminal gaps: tail mismatch columns shift the window by t;
    # after t shifts the window holds the low (k - t) history bits.
    tail = (len1 - end_i) + (len2 - end_j)
    t_cap = int(min(tail.max(initial=0), karr.max(initial=0)))
    for t in range(1, t_cap + 1):
        active = (tail >= t) & (t <= karr)
        keep = np.maximum(karr - t, 0)
        ws_t = _popcount(hist & ((np.int64(1) << keep) - 1))
        hit = active & (cc + t >= karr) & (ws_t >= midarr)
        wc += hit.astype(np.int64)
    # columns shifted fully out of the window: wsum = 0
    extra = np.maximum(tail - karr, 0)
    wc += np.where(midarr <= 0, extra, 0)

    total = cc + tail
    ident = mc / np.maximum(total, 1)
    ok = total >= karr
    r1 = np.where(ok, wc / len1, 0.0)
    r2 = np.where(ok, wc / len2, 0.0)
    return [(float(r1[i]), float(r2[i]), float(ident[i])) for i in range(B)]


def _default_rows_fn():
    from .stats_cuda import stats_rows
    return stats_rows


def plan_device(seqs, rows1, rows2, band):
    """Device chunks of a request: ``(chunks, wide)``, where each chunk is
    ``(pair indices, chunk shape)`` for one kernel launch and ``wide``
    lists the pairs of chunks too wide for one kernel block
    (:func:`fits_device`)."""
    chunks, wide = [], []
    for sl in _plan_chunks(seqs, rows1, rows2):
        shape = _chunk_shape(seqs, [rows1[i] for i in sl],
                             [rows2[i] for i in sl], band)
        if fits_device(shape[2], shape[3], shape[5]):
            chunks.append((sl, shape))
        else:
            wide.extend(sl)
    return chunks, wide


def run_device(seqs, rows1, rows2, gap_opens, ks, match_ids, chunks,
               match: int = 2, mismatch: int = -2, gap_ext: int = 1,
               band: int = 0, rows_fn=None
               ) -> List[Optional[Tuple[float, float, float]]]:
    """Launch every chunk of :func:`plan_device`; per pair
    ``(aligned_ratio_s1, aligned_ratio_s2, identity)``, None for pairs in
    no chunk.  ``rows_fn`` replaces the kernel launch (tests feed an
    emulation)."""
    assert all(1 <= ks[i] <= MAX_K for sl, _ in chunks for i in sl), \
        f"stats kernel requires k <= {MAX_K}"
    if rows_fn is None:
        rows_fn = _default_rows_fn()
    futures = []
    for sl, shape in chunks:
        futures.append((sl, _launch_chunk(
            seqs, [rows1[i] for i in sl], [rows2[i] for i in sl],
            [gap_opens[i] for i in sl], [ks[i] for i in sl],
            [match_ids[i] for i in sl],
            match, mismatch, gap_ext, band, rows_fn, shape)))
    out: List[Optional[Tuple[float, float, float]]] = [None] * len(rows1)
    # one batched fetch: every launch is in flight before the first wait
    fetched = jax.device_get([f[0] for _, f in futures])
    for (sl, fut), best in zip(futures, fetched):
        for i, r in zip(sl, _gather_chunk(best, *fut[1:])):
            out[i] = r
    return out


def sg_stats_pool_device(
    seqs: Sequence[np.ndarray],
    rows1: Sequence[int],
    rows2: Sequence[int],
    gap_opens: Sequence[int],
    ks: Sequence[int],
    match_ids: Sequence[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    band: int = 0,
    rows_fn=None,
) -> List[Tuple[float, float, float]]:
    """Per pair ``(aligned_ratio_s1, aligned_ratio_s2, identity)`` where
    pair ``p`` aligns ``seqs[rows1[p]]`` vs ``seqs[rows2[p]]``, every pair
    on the device.

    The ratios follow reference cluster.py:144-168 (k-window with >=
    match_id matches) and identity follows consensus.py:129-145, both
    measured on exactly the alignment ops/align.py would trace back
    (band=0), or its banded restriction.  Each distinct row crosses to the
    device once for the lifetime of the pool.  Raises ValueError when a
    chunk is too wide for one kernel block; ops/align.plan_stats sends
    such pairs to the host engine instead.

    ``rows_fn`` replaces the kernel launch (tests feed an emulation)."""
    if not rows1:
        return []
    chunks, wide = plan_device(seqs, rows1, rows2, band)
    if wide:
        raise ValueError(f"{len(wide)} pairs are too wide for one kernel "
                         "block (align_stats.fits_device)")
    return run_device(seqs, rows1, rows2, gap_opens, ks, match_ids, chunks,
                      match=match, mismatch=mismatch, gap_ext=gap_ext,
                      band=band, rows_fn=rows_fn)  # type: ignore[return-value]


def pool_rows(pairs):
    """``(seqs, rows1, rows2)`` of a pair list, repeated array objects
    collapsed into shared rows (RC/dup detection aligns every center
    against every other)."""
    seqs: List[np.ndarray] = []
    row_of: dict = {}
    rows1, rows2 = [], []
    for a, b in pairs:
        for arr, rows in ((a, rows1), (b, rows2)):
            key = id(arr)
            r = row_of.get(key)
            if r is None:
                r = len(seqs)
                row_of[key] = r
                seqs.append(arr)
            rows.append(r)
    return seqs, rows1, rows2


def sg_stats_batch_device(
    pairs: Sequence[Tuple[np.ndarray, np.ndarray]],
    gap_opens: Sequence[int],
    ks: Sequence[int],
    match_ids: Sequence[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    band: int = 0,
    rows_fn=None,
) -> List[Tuple[float, float, float]]:
    """Pair-list form of :func:`sg_stats_pool_device`."""
    if not pairs:
        return []
    seqs, rows1, rows2 = pool_rows(pairs)
    return sg_stats_pool_device(
        seqs, rows1, rows2, gap_opens, ks, match_ids,
        match=match, mismatch=mismatch, gap_ext=gap_ext, band=band,
        rows_fn=rows_fn)
