"""Alignment DP tests: device batch vs host oracle, and self-consistency."""

import numpy as np
import pytest

from ngspeciesid.ops.align import (
    DIAG, LEFT, UP,
    block_aligned_stats,
    identity_from_moves,
    match_vector,
    sg_align_batch,
    sg_align_numpy,
    sg_dp_numpy,
)
from ngspeciesid.utils.seqs import seq_bytes


def rand_seq(rng, n):
    return seq_bytes("".join("ACGT"[c] for c in rng.integers(0, 4, size=n)))


def mutate(rng, s, rate):
    out = []
    for c in s:
        r = rng.random()
        if r < rate / 3:
            continue  # deletion
        if r < 2 * rate / 3:
            out.extend([c, rng.integers(65, 85)])  # insertion
        elif r < rate:
            out.append(int(rng.integers(0, 4) * 2 + 65) % 256)  # substitution-ish
        else:
            out.append(c)
    return np.array(out, dtype=np.uint8)


def naive_score_of_moves(moves, s1, s2, match, mismatch, gap_open, gap_ext):
    """Score an explicit alignment with free terminal gaps."""
    # trim terminal gap runs (leading and trailing runs of pure UP or pure LEFT)
    lo, hi = 0, moves.size
    for code in (UP, LEFT):
        while lo < hi and moves[lo] == code:
            lo += 1
    for code in (UP, LEFT):
        while hi > lo and moves[hi - 1] == code:
            hi -= 1
    i = int(np.count_nonzero(moves[:lo] != LEFT))
    j = int(np.count_nonzero(moves[:lo] != UP))
    score = 0
    in_gap = 0  # 0 none, UP or LEFT
    for mv in moves[lo:hi]:
        if mv == DIAG:
            score += match if s1[i] == s2[j] else mismatch
            i += 1
            j += 1
            in_gap = 0
        else:
            score -= gap_open if in_gap != mv else gap_ext
            in_gap = mv
            if mv == UP:
                i += 1
            else:
                j += 1
    return score


def moves_reconstruct(moves, n, m):
    return (int(np.count_nonzero(moves != LEFT)) == n
            and int(np.count_nonzero(moves != UP)) == m)


class TestNumpyDP:
    @pytest.mark.parametrize("gap_open", [2, 3, 5])
    def test_optimal_and_consistent(self, rng, gap_open):
        for _ in range(25):
            a = rand_seq(rng, int(rng.integers(5, 60)))
            b = mutate(rng, a, 0.2)
            if b.size == 0:
                continue
            score, packed, end = sg_dp_numpy(a, b, gap_open=gap_open)
            moves = sg_align_numpy(a, b, gap_open)
            assert moves_reconstruct(moves, a.size, b.size)
            got = naive_score_of_moves(moves, a, b, 2, -2, gap_open, 1)
            assert got == score  # traceback path achieves the DP score

    def test_identical_seqs(self, rng):
        a = rand_seq(rng, 50)
        score, _, _ = sg_dp_numpy(a, a)
        assert score == 2 * 50
        moves = sg_align_numpy(a, a, 5)
        assert (moves == DIAG).all()
        assert identity_from_moves(moves, a, a) == 1.0

    def test_overlap_free_end_gaps(self):
        # suffix of a == prefix of b: semi-global should align the overlap
        a = seq_bytes("AAAACCCCGGGG")
        b = seq_bytes("CCCCGGGGTTTT")
        score, _, _ = sg_dp_numpy(a, b)
        assert score == 2 * 8  # 8-base overlap, terminal gaps free


class TestDeviceParity:
    def test_backends_agree(self, rng):
        pairs, opens = [], []
        for _ in range(9):
            a = rand_seq(rng, int(rng.integers(20, 120)))
            b = mutate(rng, a, 0.2)
            if b.size < 2:
                b = rand_seq(rng, 10)
            pairs.append((a, b))
            opens.append(int(rng.choice([2, 3, 4, 5])))
        jax_out = sg_align_batch(pairs, opens, backend="jax")
        np_out = sg_align_batch(pairs, opens, backend="numpy")
        for mj, mn in zip(jax_out, np_out):
            assert mj.tolist() == mn.tolist()

    def test_batch_matches_numpy(self, rng):
        pairs, opens = [], []
        for _ in range(24):
            a = rand_seq(rng, int(rng.integers(10, 150)))
            b = mutate(rng, a, 0.15)
            if b.size < 2:
                b = rand_seq(rng, 10)
            pairs.append((a, b))
            opens.append(int(rng.choice([2, 3, 4, 5])))
        got = sg_align_batch(pairs, opens)
        for (a, b), op, mv in zip(pairs, opens, got):
            want = sg_align_numpy(a, b, op)
            assert mv.tolist() == want.tolist(), (a.tobytes(), b.tobytes(), op)

    def test_batch_mixed_lengths(self, rng):
        pairs = [(rand_seq(rng, 7), rand_seq(rng, 300)),
                 (rand_seq(rng, 300), rand_seq(rng, 7)),
                 (rand_seq(rng, 64), rand_seq(rng, 64))]
        opens = [5, 3, 2]
        got = sg_align_batch(pairs, opens)
        for (a, b), op, mv in zip(pairs, opens, got):
            assert moves_reconstruct(mv, a.size, b.size)
            want = sg_align_numpy(a, b, op)
            assert mv.tolist() == want.tolist()


class TestAlignmentStats:
    def test_match_vector_naive(self, rng):
        a = rand_seq(rng, 40)
        b = mutate(rng, a, 0.2)
        moves = sg_align_numpy(a, b, 3)
        mv = match_vector(moves, a, b)
        # naive re-walk
        i = j = 0
        want = []
        for op in moves:
            if op == DIAG:
                want.append(1 if a[i] == b[j] else 0)
                i += 1
                j += 1
            else:
                want.append(0)
                i += op == UP
                j += op == LEFT
        assert mv.tolist() == want

    def test_block_stats_rolling_window(self):
        mv = np.array([1, 1, 1, 0, 1, 1, 1, 1], dtype=np.int32)
        r1, r2 = block_aligned_stats(mv, k=4, match_id=3, len1=8, len2=10)
        # windows sums: 3,3,3,3,4 -> all 5 pass
        assert r1 == 5 / 8.0
        assert r2 == 5 / 10.0
