"""numpy emulation of the CUDA stats DP's result rows (native/stats_dp.cu).

The kernel has no interpret mode, so the CPU tests feed the host side of
ngspeciesid.ops.align_stats (chunk planning, pair table, window schedule,
trailing-gap finish) from this emulation instead: the same anti-diagonal
recurrence over the same window, one (B, W) array per field, with per-lane
endpoint trackers reduced at the end.  It is a drop-in ``rows_fn``.
"""

import numpy as np

from ngspeciesid.ops.align import NEG_INF
from ngspeciesid.ops.align_stats import _popcount as _popc


def _shift(t, s, fill):
    """Lane l <- lane l - s (s in {-1, 0, 1}); lanes from outside get fill."""
    col = np.full((t.shape[0], 1), fill, t.dtype)
    if s == 1:
        return np.concatenate([col, t[:, :-1]], axis=1)
    if s == -1:
        return np.concatenate([t[:, 1:], col], axis=1)
    return t


def _shift_cell(cell, s):
    return tuple(_shift(x, s, NEG_INF if f == 0 else 0)
                 for f, x in enumerate(cell))


def emulate_rows(pool, table, base, *, W, n, m, band, match, mismatch,
                 gap_ext):
    """(B, 16) int32 result rows for the pair ``table`` over ``pool``."""
    pool = np.asarray(pool)
    table = np.asarray(table).astype(np.int64)
    base = np.asarray(base).astype(np.int64)
    B = table.shape[0]
    len1, len2 = table[:, 0:1], table[:, 1:2]
    gopen, kk, mid = table[:, 2:3], table[:, 3:4], table[:, 4:5]
    mask = (np.int64(1) << kk) - 1
    NEG = np.int64(NEG_INF)
    lanes = np.arange(W, dtype=np.int64)[None, :]

    def seq(off, length, i):
        # s[i - 1] for the lane positions i (0 where out of range)
        ok = (i >= 1) & (i <= length)
        idx = np.clip(off[:, None] + i - 1, 0, pool.size - 1)
        return np.where(ok, pool[idx], -1)

    def push(cell, bit):
        s, h, wc, mc = cell
        h2 = ((h << 1) | bit) & mask
        mc2 = mc + (bit << 16) + 1
        wc2 = wc + (((mc2 & 0xFFFF) >= kk) & (_popc(h2) >= mid))
        return s, h2, wc2, mc2

    def select(pred, a, b):
        return tuple(np.where(pred, x, y) for x, y in zip(a, b))

    zeros = np.zeros((B, W), np.int64)
    fill = (zeros + NEG, zeros, zeros, zeros)
    hd1 = (np.where(lanes == 0, 0, NEG) + zeros, zeros, zeros, zeros)
    hd2, ee, ff = fill, fill, fill
    trow = tcol = (zeros + NEG, zeros - 1, zeros, zeros, zeros, zeros)
    for dd in range(1, int((len1 + len2).max()) + 1):
        b = base[dd]
        d1 = b - base[dd - 1]
        d2 = b - base[max(dd - 2, 0)]
        iv = b + lanes
        jv = dd - iv
        in_seq = (iv >= 1) & (iv <= len1) & (jv >= 1) & (jv <= len2)
        interior = in_seq
        if band > 0:
            interior = interior & ((jv - band) * len1 <= iv * len2) & \
                (iv * len2 <= (jv + band + 1) * len1 - 1)
        boundary = ((iv == 0) & (jv >= 0) & (jv <= len2)) | \
                   ((jv == 0) & (iv <= len1))
        valid = interior | boundary

        h_e, e_e = _shift_cell(hd1, -d1), _shift_cell(ee, -d1)
        eo, ex = h_e[0] - gopen, e_e[0] - gap_ext
        enew = select(eo >= ex, h_e, e_e)
        enew = push((np.maximum(eo, ex),) + enew[1:], 0)
        h_f, f_f = _shift_cell(hd1, 1 - d1), _shift_cell(ff, 1 - d1)
        fo, fx = h_f[0] - gopen, f_f[0] - gap_ext
        fnew = select(fo >= fx, h_f, f_f)
        fnew = push((np.maximum(fo, fx),) + fnew[1:], 0)
        c1 = seq(table[:, 5], len1, iv)
        c2 = seq(table[:, 6], len2, jv)
        bit = (in_seq & (c1 == c2)).astype(np.int64)
        h_d = _shift_cell(hd2, 1 - d2)
        dnew = push((h_d[0] + np.where(bit == 1, match, mismatch),)
                    + h_d[1:], bit)

        h_no_e = np.maximum(dnew[0], fnew[0])
        hnew = select(enew[0] > h_no_e, enew,
                      select(fnew[0] > dnew[0], fnew, dnew))
        hnew = (np.maximum(h_no_e, enew[0]),) + hnew[1:]
        ddv = zeros + dd
        wc0 = np.where(mid <= 0, np.maximum(ddv - kk + 1, 0), 0)
        hnew = select(boundary, (zeros, zeros, wc0, ddv), hnew)
        hnew = (np.where(valid, hnew[0], NEG),) + hnew[1:]

        def track(trk, on, coord):
            take = on & (hnew[0] >= trk[0])
            payload = (hnew[0], coord) + hnew[1:] + (ddv,)
            return tuple(np.where(take, p, t) for p, t in zip(payload, trk))

        trow = track(trow, valid & (iv == len1), jv)
        tcol = track(tcol, valid & (jv == len2), iv)
        hd1, hd2, ee, ff = hnew, hd1, enew, fnew

    def finish(trk):
        s, coord, h, wc, mc, dd = trk
        at_max = s == s.max(axis=1, keepdims=True)
        dbest = np.where(at_max, dd, -1).max(axis=1, keepdims=True)
        pick = at_max & (dd == dbest)

        def get(x, empty):
            return np.where(pick, x, empty).max(axis=1)

        hist, mcv = get(h, -1), get(mc, -1)
        return [get(s, NEG), get(coord, -1), hist, _popc(hist), get(wc, -1),
                mcv >> 16, mcv & 0xFFFF, get(dd, -1)]

    return np.stack(finish(trow) + finish(tcol), axis=1).astype(np.int32)
