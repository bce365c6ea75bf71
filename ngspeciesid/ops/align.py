"""Batched semi-global (overlap) alignment with affine gaps.

Batched replacement for the reference's parasail usage (N1 in SURVEY.md):
``sg_trace_scan_16/32`` with a match/mismatch matrix over "ACGT", affine gaps
where a gap of length L costs ``open + (L-1) * ext``, and FREE terminal gaps
on both sequences (reference cluster.py:130-142, consensus.py:58-73).

The reference only consumes two derived statistics of the optimal alignment:

  * cluster fallback: the per-column match vector fed through a rolling
    window of size k with threshold ``match_id`` -> aligned-region ratio
    (cluster.py:144-169);
  * RC/dup detection: column identity = matching columns / alignment length
    (consensus.py:129-145).

So the DP here computes a move matrix whose (cheap, O(n+m)) traceback and
column statistics run vectorized on the host; the stats-only device DP
(ops/align_stats.py) propagates the two statistics forward instead.
Alignment columns include terminal gaps, exactly like a parasail CIGAR.

Determinism: when scores tie, moves prefer diagonal > gap-in-s2 (up) >
gap-in-s1 (left), and the alignment endpoint prefers the (n, m)-corner-most
cell of the last row, then of the last column.  parasail's internal
tie-breaking is unspecified; all consumers threshold on ratios, so decisions
only differ for exactly-on-threshold ties.

Dtype: int32 throughout — no 16->32-bit saturation retry needed (the
reference's parasail_16 overflow fallback, cluster.py:133-136, is subsumed).
"""

from __future__ import annotations

import functools
import os
from typing import List, Optional, Tuple

import numpy as np

import jax
import jax.numpy as jnp

NEG_INF = np.int32(-(2**30))

# move codes in the H-choice matrix
DIAG, UP, LEFT = 1, 2, 3  # UP = gap in s2 (consume s1), LEFT = gap in s1


# ---------------------------------------------------------------------------
# numpy implementation (oracle + small-batch host path)
# ---------------------------------------------------------------------------

def sg_dp_numpy(
    s1: np.ndarray, s2: np.ndarray, match: int = 2, mismatch: int = -2,
    gap_open: int = 5, gap_ext: int = 1,
) -> Tuple[int, np.ndarray, Tuple[int, int]]:
    """Full Gotoh DP (sequential host oracle).

    Returns ``(score, packed, end)`` where packed is (n+1, m) uint8 with
    move code in bits 0-1, Eopen in bit 2, Fopen in bit 3 for columns 1..m
    (same layout as the device kernel).
    """
    n, m = s1.size, s2.size
    H = np.zeros((n + 1, m + 1), dtype=np.int64)
    packed = np.zeros((n + 1, m), dtype=np.uint8)
    F = np.full((m + 1,), NEG_INF, dtype=np.int64)
    Hprev = H[0]
    for i in range(1, n + 1):
        Hcur = np.empty(m + 1, dtype=np.int64)
        Hcur[0] = 0  # free leading gap in s2
        sub = np.where(s2 == s1[i - 1], match, mismatch)
        f_open = Hprev - gap_open
        f_ext = F - gap_ext
        fopen_row = f_open >= f_ext
        F = np.maximum(f_open, f_ext)
        e = NEG_INF
        for j in range(1, m + 1):
            e_open = Hcur[j - 1] - gap_open
            e_ext = e - gap_ext
            eopen = e_open >= e_ext
            e = e_open if eopen else e_ext
            diag = Hprev[j - 1] + sub[j - 1]
            h, mv = diag, DIAG
            if F[j] > h:
                h, mv = F[j], UP
            if e > h:
                h, mv = e, LEFT
            Hcur[j] = h
            packed[i, j - 1] = mv | (int(eopen) << 2) | (int(fopen_row[j]) << 3)
        Hprev = Hcur
        H[i] = Hcur
    score, end = _best_end(H, n, m)
    return int(score), packed, end


def _best_end(H: np.ndarray, n: int, m: int) -> Tuple[int, Tuple[int, int]]:
    """Endpoint: max score over last row/col; prefer corner-most in last row,
    then corner-most in last column."""
    best = None
    # last row, j descending (corner first)
    row = H[n, :]
    col = H[:, m]
    jmax = int(np.argmax(row[::-1]))
    j_best = m - jmax
    imax = int(np.argmax(col[::-1]))
    i_best = n - imax
    if row[j_best] >= col[i_best]:
        best = (int(row[j_best]), (n, j_best))
    else:
        best = (int(col[i_best]), (i_best, m))
    return best


def traceback_moves(
    packed: np.ndarray, n: int, m: int, end: Tuple[int, int]
) -> np.ndarray:
    """Decode the alignment column moves (full-span, terminal gaps included).

    ``packed``: (n+1, m) uint8, bits 0-1 move, bit 2 Eopen, bit 3 Fopen,
    column j stored at index j-1.  Returns move codes (DIAG/UP/LEFT)
    covering all of s1 and s2.
    """
    i, j = end
    ops: List[int] = []
    ops.extend([UP] * (n - i))     # terminal gap: unaligned s1 suffix
    ops.extend([LEFT] * (m - j))   # terminal gap: unaligned s2 suffix
    state = 0  # 0 = in H, 1 = in E (left-gap run), 2 = in F (up-gap run)
    while i > 0 and j > 0:
        cell = packed[i, j - 1]
        if state == 0:
            mv = cell & 3
            if mv == DIAG:
                ops.append(DIAG)
                i -= 1
                j -= 1
            elif mv == LEFT:
                state = 1
            else:
                state = 2
        elif state == 1:
            ops.append(LEFT)
            opened = cell & 4
            j -= 1
            if opened:
                state = 0
        else:
            ops.append(UP)
            opened = cell & 8
            i -= 1
            if opened:
                state = 0
    ops.extend([UP] * i)
    ops.extend([LEFT] * j)
    return np.array(ops[::-1], dtype=np.uint8)


def match_vector(moves: np.ndarray, s1: np.ndarray, s2: np.ndarray) -> np.ndarray:
    """Per-alignment-column match indicator (gap columns are mismatches)."""
    i = np.cumsum(moves != LEFT)  # s1 index (1-based) at each column
    j = np.cumsum(moves != UP)
    is_diag = moves == DIAG
    out = np.zeros(moves.size, dtype=np.int32)
    idx = np.flatnonzero(is_diag)
    out[idx] = (s1[i[idx] - 1] == s2[j[idx] - 1]).astype(np.int32)
    return out


def block_aligned_stats(
    mv: np.ndarray, k: int, match_id: int, len1: int, len2: int
) -> Tuple[float, float]:
    """Rolling-window aligned-region ratios (reference cluster.py:144-168).

    A window of k consecutive alignment columns counts as 'aligned' if it has
    at least ``match_id`` matches; ratio = #aligned windows / len(s).
    """
    if mv.size < k:
        return 0.0, 0.0
    window_sums = np.convolve(mv, np.ones(k, dtype=np.int32), mode="valid")
    aligned = int(np.count_nonzero(window_sums >= match_id))
    return aligned / float(len1), aligned / float(len2)


def identity_from_moves(moves: np.ndarray, s1: np.ndarray, s2: np.ndarray) -> float:
    """Column identity over the full alignment span (consensus.py:129-145)."""
    mv = match_vector(moves, s1, s2)
    return float(mv.sum()) / float(moves.size)


# ---------------------------------------------------------------------------
# JAX batched implementation (device path)
# ---------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("n", "m", "gap_ext",))
def _sg_dp_jax(
    s1b: jnp.ndarray, s2b: jnp.ndarray, len1: jnp.ndarray, len2: jnp.ndarray,
    match: jnp.ndarray, mismatch: jnp.ndarray, gap_open: jnp.ndarray,
    n: int, m: int, gap_ext: int = 1,
):
    """Row-scan Gotoh DP over a padded batch.

    s1b: (B, n) uint8 codes; s2b: (B, m); len1/len2: (B,) actual lengths.
    gap_open: (B,) per-pair open penalty (the reference tiers it by error
    rate, cluster.py:189-196).
    Returns (scores, end_i, end_j, packed) where packed is (B, n+1, m+1)
    uint8 encoding move (2 bits) | Eopen << 2 | Fopen << 3.

    The E-recurrence (gap along the row) is rewritten as a running max so
    each row is one associative scan instead of a sequential j-loop:
      T[j] = max_{j'<=j} (H[j'-1] - open + j'*ext),   E[j] = T[j] - j*ext
    which XLA lowers to a cumulative max.  Using max(diag, F)
    instead of the final H as the E source is exact (classic Gotoh property:
    a gap reopened from inside another left-gap is dominated by extending).
    """
    B = s1b.shape[0]
    NEG = jnp.int32(NEG_INF)
    jj = jnp.arange(1, m + 1, dtype=jnp.int32)  # column numbers 1..m
    ext = jnp.int32(gap_ext)
    col_valid = jj[None, :] <= len2[:, None]                      # (B, m)
    col_valid_h = jnp.concatenate(
        [jnp.ones((B, 1), bool), col_valid], axis=1)              # (B, m+1)

    H0 = jnp.where(col_valid_h, jnp.zeros((B, m + 1), jnp.int32), NEG)
    F0 = jnp.full((B, m + 1), NEG, jnp.int32)

    def row_step(carry, xi):
        Hprev, Fprev, last_row = carry          # (B, m+1) each
        s1_char, i_idx = xi                     # (B,), scalar row idx (1-based)
        valid_i = i_idx <= len1                 # (B,)
        sub = jnp.where(s2b == s1_char[:, None], match[:, None], mismatch[:, None])
        # F: vertical gap (consume s1), elementwise from previous row
        f_open = Hprev - gap_open[:, None]
        f_ext = Fprev - ext
        fopen_row = f_open >= f_ext
        F = jnp.maximum(f_open, f_ext)
        diag = Hprev[:, :-1] + sub              # (B, m)
        h_no_e = jnp.maximum(diag, F[:, 1:])
        # E via running max (see docstring); prevH[j] = H[i][j-1], j = 1..m
        prevH = jnp.concatenate(
            [jnp.zeros((B, 1), jnp.int32), h_no_e[:, :-1]], axis=1)
        g = prevH - gap_open[:, None] + jj[None, :] * ext
        T = jax.lax.associative_scan(jnp.maximum, g, axis=1)
        E = T - jj[None, :] * ext
        eopen_row = g >= T                      # E opened here (from H[i][j-1])
        H_in = jnp.maximum(h_no_e, E)
        moves_row = jnp.where(
            E > h_no_e, jnp.uint8(LEFT),
            jnp.where(F[:, 1:] > diag, jnp.uint8(UP), jnp.uint8(DIAG)),
        )
        packed_row = (moves_row
                      | (eopen_row.astype(jnp.uint8) << 2)
                      | (fopen_row[:, 1:].astype(jnp.uint8) << 3))
        packed_row = jnp.where(valid_i[:, None], packed_row, jnp.uint8(0))
        Hrow = jnp.concatenate([jnp.zeros((B, 1), jnp.int32), H_in], axis=1)
        Hrow = jnp.where(col_valid_h, Hrow, NEG)
        Hrow = jnp.where(valid_i[:, None], Hrow, Hprev)
        Fout = jnp.where(valid_i[:, None], F, Fprev)
        last_row = jnp.where((i_idx == len1)[:, None], Hrow, last_row)
        col_val = jnp.take_along_axis(Hrow, len2[:, None], axis=1)[:, 0]
        return (Hrow, Fout, last_row), (packed_row, col_val)

    i_ids = jnp.arange(1, n + 1, dtype=jnp.int32)
    (_, _, last_row), (packed, col_vals) = jax.lax.scan(
        row_step, (H0, F0, H0), (s1b.T, i_ids)
    )
    # last column of H per pair: H[i][len2] for i = 0..n
    col0 = jnp.take_along_axis(H0, len2[:, None], axis=1)[:, 0]
    last_col = jnp.concatenate([col0[:, None], col_vals.T], axis=1)  # (B, n+1)

    def corner_argmax(x, valid_len):
        idx = jnp.arange(x.shape[1])
        masked = jnp.where(idx[None] <= valid_len[:, None], x, NEG)
        best = jnp.max(masked, axis=1)
        pick = jnp.max(jnp.where(masked == best[:, None], idx[None], -1), axis=1)
        return best, pick

    row_best, row_j = corner_argmax(last_row, len2)
    col_best, col_i = corner_argmax(last_col, len1)
    use_row = row_best >= col_best
    scores = jnp.where(use_row, row_best, col_best)
    end_i = jnp.where(use_row, len1, col_i)
    end_j = jnp.where(use_row, row_j, len2)
    packed_full = jnp.concatenate(
        [jnp.zeros((1, B, m), jnp.uint8), packed], axis=0
    ).transpose(1, 0, 2)  # (B, n+1, m)
    return scores, end_i, end_j, packed_full


def _sg_dp_np_batch(
    s1b: np.ndarray, s2b: np.ndarray, len1: np.ndarray, len2: np.ndarray,
    match: int, mismatch: int, gap_open: np.ndarray, gap_ext: int,
):
    """Compile-free numpy mirror of :func:`_sg_dp_jax` (same recurrences,
    same tie-breaking; row loop in Python, columns and batch vectorized).
    Used on CPU and for small/irregular batches where XLA compilation of a
    fresh shape would dominate."""
    B, n = s1b.shape
    m = s2b.shape[1]
    NEG = np.int32(NEG_INF)
    jj = np.arange(1, m + 1, dtype=np.int32)
    go = gap_open[:, None].astype(np.int32)
    col_valid_h = np.concatenate(
        [np.ones((B, 1), bool), jj[None, :] <= len2[:, None]], axis=1)
    H = np.where(col_valid_h, np.zeros((B, m + 1), np.int32), NEG)
    F = np.full((B, m + 1), NEG, np.int32)
    last_row = H.copy()
    packed = np.zeros((B, n + 1, m), dtype=np.uint8)
    col_vals = np.empty((B, n + 1), dtype=np.int32)
    col_vals[:, 0] = np.take_along_axis(H, len2[:, None], axis=1)[:, 0]
    ar = np.arange(B)
    for i in range(1, n + 1):
        valid_i = (i <= len1)[:, None]
        sub = np.where(s2b == s1b[:, i - 1][:, None], match, mismatch).astype(np.int32)
        f_open = H - go
        f_ext = F - gap_ext
        fopen_row = f_open >= f_ext
        Fn = np.maximum(f_open, f_ext)
        diag = H[:, :-1] + sub
        h_no_e = np.maximum(diag, Fn[:, 1:])
        prevH = np.concatenate([np.zeros((B, 1), np.int32), h_no_e[:, :-1]], axis=1)
        g = prevH - go + jj[None, :] * gap_ext
        T = np.maximum.accumulate(g, axis=1)
        E = T - jj[None, :] * gap_ext
        eopen_row = g >= T
        moves_row = np.where(
            E > h_no_e, np.uint8(LEFT),
            np.where(Fn[:, 1:] > diag, np.uint8(UP), np.uint8(DIAG)),
        )
        packed_row = (moves_row
                      | (eopen_row.astype(np.uint8) << 2)
                      | (fopen_row[:, 1:].astype(np.uint8) << 3))
        packed[:, i, :] = np.where(valid_i, packed_row, 0)
        Hrow = np.concatenate(
            [np.zeros((B, 1), np.int32), np.maximum(h_no_e, E)], axis=1)
        Hrow = np.where(col_valid_h, Hrow, NEG)
        H = np.where(valid_i, Hrow, H)
        F = np.where(valid_i, Fn, F)
        last_row = np.where((i == len1)[:, None], H, last_row)
        col_vals[:, i] = H[ar, len2]

    def corner_argmax(x, valid_len):
        idx = np.arange(x.shape[1])
        masked = np.where(idx[None] <= valid_len[:, None], x, NEG)
        best = masked.max(axis=1)
        pick = np.where(masked == best[:, None], idx[None], -1).max(axis=1)
        return best, pick

    row_best, row_j = corner_argmax(last_row, len2)
    col_best, col_i = corner_argmax(col_vals, len1)
    use_row = row_best >= col_best
    scores = np.where(use_row, row_best, col_best)
    end_i = np.where(use_row, len1, col_i)
    end_j = np.where(use_row, row_j, len2)
    return scores, end_i, end_j, packed


def _pad_batch(seqs: List[np.ndarray], width: int) -> np.ndarray:
    out = np.zeros((len(seqs), width), dtype=np.uint8)
    for i, s in enumerate(seqs):
        out[i, : s.size] = s
    return out


def _bucket_width(x: int) -> int:
    """Round up to limit distinct compiled shapes."""
    w = 64
    while w < x:
        w = w * 2 if w < 1024 else w + 512
    return w


#: compute capability the device DP library is built for
#: (``-gencode arch=compute_90a,code=sm_90a``, ops/stats_cuda.py)
DEVICE_DP_CAPABILITY = "9.0"


def device_dp_available() -> bool:
    """True when the default JAX backend is a Hopper GPU, the card the
    device stats DP (ops/align_stats.py) is built for.  Other GPUs run the
    host engine."""
    if jax.default_backend() != "gpu":
        return False
    return all(getattr(d, "compute_capability", None) == DEVICE_DP_CAPABILITY
               for d in jax.local_devices())


def sg_align_batch(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
    backend: Optional[str] = None,
    band: int = 0,
) -> List[np.ndarray]:
    """Align a batch of byte-sequence pairs; return per-pair move arrays
    (full alignment columns incl. terminal gaps).

    backend: "native" (C++ engine), "jax", "numpy", or None for auto
    (native when it builds, else numpy).  band > 0 restricts the native DP
    to +-band of the scaled main diagonal (exact whenever the optimal path
    stays inside, i.e. for same-template amplicon pairs); the jax/numpy
    backends always run the full DP.  The XLA scan compiles a sequential
    graph per shape bucket, so auto mode never picks it; it stays
    available explicitly and parity-tested."""
    if not pairs:
        return []
    B = len(pairs)
    if backend is None:
        from .. import native
        backend = "native" if native.available() else "numpy"
    if backend == "native":
        from .. import native
        return native.align_batch_native(pairs, gap_opens, match, mismatch,
                                         gap_ext, band=band)
    if backend == "jax":
        # coarse power-of-two-ish buckets: bound compiled-shape diversity
        n = _bucket_width(max(a.size for a, _ in pairs))
        m = _bucket_width(max(b.size for _, b in pairs))
    else:
        # numpy mirror has no compile cost: pad tightly
        n = -(-max(a.size for a, _ in pairs) // 64) * 64
        m = -(-max(b.size for _, b in pairs) // 64) * 64
    # bound the packed-move matrix memory by chunking large batches
    max_chunk = max(1, (256 << 20) // max(1, (n + 1) * m))
    if B > max_chunk:
        out: List[np.ndarray] = []
        for s in range(0, B, max_chunk):
            out.extend(
                sg_align_batch(pairs[s : s + max_chunk], gap_opens[s : s + max_chunk],
                               match, mismatch, gap_ext, backend, band)
            )
        return out
    s1b = _pad_batch([a for a, _ in pairs], n)
    s2b = _pad_batch([b for _, b in pairs], m)
    len1 = np.array([a.size for a, _ in pairs], dtype=np.int32)
    len2 = np.array([b.size for _, b in pairs], dtype=np.int32)
    opens = np.asarray(gap_opens, dtype=np.int32)
    if backend == "jax":
        # pad the batch to a power of two to bound compiled-shape diversity
        Bp = 1 << (B - 1).bit_length()
        if Bp != B:
            s1b = np.concatenate([s1b, np.zeros((Bp - B, n), np.uint8)])
            s2b = np.concatenate([s2b, np.zeros((Bp - B, m), np.uint8)])
            len1 = np.concatenate([len1, np.ones(Bp - B, np.int32)])
            len2 = np.concatenate([len2, np.ones(Bp - B, np.int32)])
            opens = np.concatenate([opens, np.full(Bp - B, 5, np.int32)])
        scores, end_i, end_j, packed = _sg_dp_jax(
            jnp.asarray(s1b), jnp.asarray(s2b), jnp.asarray(len1), jnp.asarray(len2),
            jnp.full((Bp,), match, jnp.int32), jnp.full((Bp,), mismatch, jnp.int32),
            jnp.asarray(opens), n=n, m=m, gap_ext=gap_ext,
        )
        packed = np.asarray(packed)
        end_i = np.asarray(end_i)
        end_j = np.asarray(end_j)
    else:
        scores, end_i, end_j, packed = _sg_dp_np_batch(
            s1b, s2b, len1, len2, match, mismatch, opens, gap_ext
        )
    out = []
    for b in range(B):
        out.append(
            traceback_moves(packed[b], int(len1[b]), int(len2[b]),
                            (int(end_i[b]), int(end_j[b])))
        )
    return out


def sg_align_numpy(
    s1: np.ndarray, s2: np.ndarray, gap_open: int,
    match: int = 2, mismatch: int = -2, gap_ext: int = 1,
) -> np.ndarray:
    """Single-pair host path returning alignment moves (oracle-grade)."""
    score, packed, end = sg_dp_numpy(s1, s2, match, mismatch, gap_open, gap_ext)
    return traceback_moves(packed, s1.size, s2.size, end)


# ---------------------------------------------------------------------------
# stats-only dispatch: the two statistics every consumer actually needs
# ---------------------------------------------------------------------------

def stats_backend_default() -> str:
    """Pick the stats-only alignment backend.

    ``NGSID_STATS_BACKEND`` overrides (native | device | host).  Otherwise
    the device DP on a Hopper GPU host (:func:`device_dp_available`), else
    the native C++ engine, else the host traceback mirror.  There a device
    DP that fails to build or load raises; it never gives way to the host
    engine."""
    env = os.environ.get("NGSID_STATS_BACKEND", "").strip().lower()
    if env:
        return env
    if device_dp_available():
        return "device"
    from .. import native
    if native.available():
        return "native"
    return "host"


#: Smallest batch the device DP takes when the native engine is built;
#: smaller ones run there.  The H100 launch-cost ladder (CHANGES.md) found
#: no batch size at which the device DP beats the native engine on a
#: 16-core host: a call costs ~2 ms plus ~8 us per 700 bp pair at band 150,
#: the native engine ~6.8 us per pair.  256 is a plain default: it keeps
#: the batches where the fixed cost weighs most on the host, while the
#: device DP stays the default on a GPU host.
DEVICE_MIN_BATCH = 256


def plan_stats(seqs, rows1, rows2, band: int = 0,
               backend: Optional[str] = None):
    """The one dispatch of the stats DP: which pairs run where.

    Pair ``p`` aligns ``seqs[rows1[p]]`` with ``seqs[rows2[p]]``.  Returns
    ``(chunks, rest, rest_backend)``: ``chunks`` are device-kernel launches
    (align_stats.plan_device) and the pair indices in ``rest`` run on
    ``rest_backend``.  On the device backend, batches under
    DEVICE_MIN_BATCH pairs and chunks too wide for one kernel block go to
    the native engine, or to the host mirror when it is not built."""
    backend = backend or stats_backend_default()
    everything = list(range(len(rows1)))
    if backend != "device":
        return [], everything, backend
    from .. import native
    rest_backend = "native" if native.available() else "host"
    if len(rows1) < DEVICE_MIN_BATCH and rest_backend == "native":
        return [], everything, rest_backend
    from .align_stats import plan_device
    chunks, wide = plan_device(seqs, rows1, rows2, band)
    return chunks, wide, rest_backend


def run_stats(seqs, rows1, rows2, gap_opens, ks, match_ids, band: int,
              backend: Optional[str], rest_fn, pick):
    """Run :func:`plan_stats`' plan.  Device results pass through
    ``pick((ratio1, ratio2, identity))``; the rest come from
    ``rest_fn(indices, rest_backend)`` in the order of ``indices``."""
    chunks, rest, rest_backend = plan_stats(seqs, rows1, rows2, band, backend)
    out: list = [None] * len(rows1)
    if chunks:
        from .align_stats import run_device
        dev = run_device(seqs, rows1, rows2, gap_opens, ks, match_ids,
                         chunks, band=band)
        for sl, _ in chunks:
            for i in sl:
                out[i] = pick(dev[i])
    if rest:
        for i, r in zip(rest, rest_fn(rest, rest_backend)):
            out[i] = r
    return out


def _pair_lists(pairs, idx, *cols):
    """The pairs and per-pair columns at ``idx``, in that order."""
    return tuple([c[i] for i in idx] for c in (pairs,) + cols)


def block_stats_batch(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int], ks: List[int], match_ids: List[int],
    band: int = 0, backend: Optional[str] = None,
) -> List[Tuple[float, float]]:
    """Per-pair (aligned_ratio_s1, aligned_ratio_s2) of the reference's
    rolling-k-window fallback statistic (cluster.py:144-168), on the
    backends :func:`plan_stats` picks.  band narrows both the native
    engine and the device DP (identical in-band semantics whenever the
    optimal path stays inside; see align_stats.py)."""
    if not pairs:
        return []

    def rest(idx, be):
        sub, opens, kk, mids = _pair_lists(pairs, idx, gap_opens, ks,
                                           match_ids)
        if be == "native":
            from .. import native
            return native.block_stats_native(sub, opens, kk, mids, band=band)
        moves = sg_align_batch(sub, opens, band=band)
        return [block_aligned_stats(match_vector(mv, a, b), k, mid,
                                    a.size, b.size)
                for mv, (a, b), k, mid in zip(moves, sub, kk, mids)]

    from .align_stats import pool_rows
    return run_stats(*pool_rows(pairs), gap_opens, ks, match_ids, band,
                     backend, rest, lambda st: (st[0], st[1]))


def identity_batch(
    pairs: List[Tuple[np.ndarray, np.ndarray]],
    gap_opens: List[int],
    band: int = 0, backend: Optional[str] = None,
) -> List[float]:
    """Per-pair column identity (consensus.py:129-145), on the backends
    :func:`plan_stats` picks."""
    if not pairs:
        return []

    def rest(idx, be):
        sub, opens = _pair_lists(pairs, idx, gap_opens)
        if be == "native":
            from .. import native
            return native.identity_native(sub, opens, band=band)
        moves = sg_align_batch(sub, opens, band=band)
        return [identity_from_moves(mv, a, b)
                for mv, (a, b) in zip(moves, sub)]

    from .align_stats import pool_rows
    ones = [1] * len(pairs)
    return run_stats(*pool_rows(pairs), gap_opens, ones, ones, band,
                     backend, rest, lambda st: st[2])
