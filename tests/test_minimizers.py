"""Property tests: packed-code minimizer engine vs string oracle."""

import numpy as np
import pytest

from ngspeciesid.ops.minimizers import (
    alphabet_ranks,
    batch_minimizers,
    kmer_codes,
    sequence_minimizers,
)
from ngspeciesid.utils.seqs import seq_bytes

from .oracle.minimizers import minimizers as oracle_minimizers

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def _check(seq: str, k: int, w: int):
    rank_of, rank_bits = alphabet_ranks(seq_bytes(seq))
    codes, pos = sequence_minimizers(seq_bytes(seq), k, w, rank_of, rank_bits)
    want = oracle_minimizers(seq, k, w)
    got_pos = pos.tolist()
    assert got_pos == [p for _, p in want], (seq, k, w)
    # decode equality via code identity: same code <=> same kmer string
    code_at = kmer_codes(seq_bytes(seq), k, rank_of, rank_bits)
    for c, p, (kmer, _) in zip(codes.tolist(), got_pos, want):
        if p < len(seq):
            assert c == code_at[p]
        # kmer value round-trip: codes at equal positions must match
        assert kmer == seq[p : p + k]


class TestMinimizerParity:
    @pytest.mark.parametrize("k,w", [(13, 20), (15, 50), (5, 9), (3, 3)])
    def test_random_acgt(self, rng, k, w):
        for _ in range(40):
            n = int(rng.integers(k, 400))
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
            _check(seq, k, w)

    def test_low_complexity(self, rng):
        # repeats produce many duplicate kmers -> exercises re-emission rules
        for _ in range(30):
            n = int(rng.integers(13, 200))
            seq = "".join("AC"[c] for c in rng.integers(0, 2, size=n))
            _check(seq, 13, 20)

    def test_short_sequences_truncated_kmers(self, rng):
        # L < w: the single window contains truncated kmers
        for n in range(13, 21):
            for _ in range(10):
                seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
                _check(seq, 13, 20)

    def test_empty_kmers_in_window(self, rng):
        # isoseq params with L < w - k + 1: window contains EMPTY kmers,
        # which are the lexicographic minimum
        for n in range(15, 40):
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
            _check(seq, 15, 50)

    def test_non_acgt_alphabet(self, rng):
        # N sorts between G and T in ASCII; rank packing must preserve that
        for _ in range(20):
            n = int(rng.integers(26, 200))
            seq = "".join("ACGNT"[c] for c in rng.integers(0, 5, size=n))
            _check(seq, 13, 20)

    def test_code_equality_is_string_equality(self, rng):
        rank_of, rank_bits = alphabet_ranks(ACGT)
        seen = {}
        for _ in range(200):
            n = int(rng.integers(13, 60))
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))
            codes, pos = sequence_minimizers(seq_bytes(seq), 13, 20, rank_of, rank_bits)
            for c, p in zip(codes.tolist(), pos.tolist()):
                kmer = seq[p : p + 13]
                if c in seen:
                    assert seen[c] == kmer
                else:
                    seen[c] = kmer

    def test_batch_matches_single(self, rng):
        rank_of, rank_bits = alphabet_ranks(ACGT)
        seqs = [
            np.frombuffer("".join("ACGT"[c] for c in rng.integers(0, 4, size=int(n))).encode(),
                          dtype=np.uint8)
            for n in rng.integers(13, 300, size=20)
        ]
        batch = batch_minimizers(seqs, 13, 20, rank_of, rank_bits)
        for seq, (bc, bp) in zip(seqs, batch):
            sc, sp = sequence_minimizers(seq, 13, 20, rank_of, rank_bits)
            assert bc.tolist() == sc.tolist()
            assert bp.tolist() == sp.tolist()
