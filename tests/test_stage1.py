"""Stage-1 (score/filter/sort) parity and behaviour tests."""

import os

import numpy as np
import pytest

from ngspeciesid.config import Config
from ngspeciesid.io.fastx import read_fastx
from ngspeciesid.ops.score import batch_error_rates, batch_scores, score_single
from ngspeciesid.preprocess import score_and_sort
from ngspeciesid.utils.seqs import hpol_compress, hpol_compressed_qual_bytes, seq_bytes
from ngspeciesid.utils.phred import qual_bytes

from .oracle import stage1 as oracle


def random_qual(rng, n):
    return "".join(chr(c) for c in rng.integers(33, 75, size=n))


def random_seq(rng, n):
    return "".join("ACGT"[c] for c in rng.integers(0, 4, size=n))


class TestScoreParity:
    def test_bit_exact_vs_oracle(self, rng):
        k = 13
        quals = [random_qual(rng, int(n)) for n in rng.integers(30, 900, size=64)]
        got = batch_scores([qual_bytes(q) for q in quals], k)
        want = np.array([oracle.score(q, k) for q in quals])
        assert got.tolist() == want.tolist()  # bit-exact, not approx

    def test_bit_exact_extreme_quals(self):
        k = 13
        quals = ["!" * 30, "~" * 30, "!~" * 20, chr(33 + 40) * 26]
        for q in quals:
            assert score_single(q, k) == oracle.score(q, k)

    def test_error_rate_matches_oracle(self, rng):
        quals = [random_qual(rng, int(n)) for n in rng.integers(26, 400, size=32)]
        got = batch_error_rates([qual_bytes(q) for q in quals])
        for g, q in zip(got, quals):
            assert g == pytest.approx(oracle.error_rate(q), rel=1e-15)


class TestSeqUtils:
    def test_hpol_compress(self, rng):
        for _ in range(50):
            s = random_seq(rng, int(rng.integers(1, 200)))
            assert hpol_compress(s) == oracle.hpol_compress(s)

    def test_hpol_qual_picks_best_first(self):
        seq = seq_bytes("AAACCT")
        qual = qual_bytes("!5$77#")
        # runs: AAA -> best of "!5$" is '5'; CC -> first-best of "77" is '7'; T -> '#'
        out = hpol_compressed_qual_bytes(seq, qual)
        assert out.tobytes() == b"57#"

    def test_hpol_qual_tie_takes_first(self):
        seq = seq_bytes("AAAA")
        qual = qual_bytes("5855")
        out = hpol_compressed_qual_bytes(seq, qual)
        assert out.tobytes() == b"8"


class TestStage1EndToEnd:
    def _write_fastq(self, path, records):
        with open(path, "w") as f:
            for name, seq, qual in records:
                f.write(f"@{name}\n{seq}\n+\n{qual}\n")

    def test_sorting_and_format(self, tmp_path, rng):
        records = []
        for i in range(40):
            n = int(rng.integers(30, 300))
            records.append((f"read_{i} extra", random_seq(rng, n), random_qual(rng, n)))
        # one too-short read and one low-quality read to exercise filters
        records.append(("short", "ACGT", "IIII"))
        records.append(("lowq", random_seq(rng, 100), "!" * 100))
        fq = tmp_path / "in.fastq"
        self._write_fastq(fq, records)

        cfg = Config(fastq=str(fq), outfolder=str(tmp_path), k=13, quality_threshold=7.0)
        out = score_and_sort(cfg)

        parsed = list(read_fastx(out))
        # Order: descending score, formatted as str(float) suffix
        scores = [float(name.rsplit("_", 1)[1]) for name, _, _ in parsed]
        assert scores == sorted(scores, reverse=True)
        assert all(name.rsplit("_", 1)[0].startswith(("read_", "short", "lowq"))
                   for name, _, _ in parsed)
        # filters dropped the two bad reads
        kept_names = {name.rsplit("_", 1)[0] for name, _, _ in parsed}
        assert "short" not in kept_names
        assert "lowq" not in kept_names
        # score suffix matches oracle bit-exactly (str formatting contract)
        for name, seq, qual in parsed:
            suffix = name.rsplit("_", 1)[1]
            assert suffix == str(oracle.score(qual, 13))
        # logfile written with four stats lines
        log = (tmp_path / "logfile.txt").read_text().strip().split("\n")
        assert len(log) == 4
        assert log[0].startswith("Lowest read error rate:")

    def test_use_old_sorted_file(self, tmp_path):
        fq = tmp_path / "in.fastq"
        self._write_fastq(fq, [("a", "ACGTACGTACGTACGTACGTACGTACG", "I" * 27)])
        cfg = Config(fastq=str(fq), outfolder=str(tmp_path))
        out1 = score_and_sort(cfg)
        content = open(out1).read()
        cfg.use_old_sorted_file = True
        out2 = score_and_sort(cfg)
        assert out1 == out2
        assert open(out2).read() == content

    def test_sample_h1_runs(self, tmp_path, sample_fastq):
        cfg = Config(fastq=sample_fastq, outfolder=str(tmp_path), k=13, w=20)
        out = score_and_sort(cfg)
        parsed = list(read_fastx(out))
        assert len(parsed) > 200  # most of the 280 reads pass
        scores = [float(name.rsplit("_", 1)[1]) for name, _, _ in parsed]
        assert scores == sorted(scores, reverse=True)


class TestFastxParser:
    def test_multiline_fasta_and_fastq(self, tmp_path):
        p = tmp_path / "mix.fa"
        p.write_text(">a desc\nACGT\nACGT\n@b\nGGGG\n+\nIIII\n>c\nTT\n")
        recs = list(read_fastx(str(p)))
        assert recs[0] == ("a desc", "ACGTACGT", None)
        assert recs[1] == ("b", "GGGG", "IIII")
        assert recs[2] == ("c", "TT", None)

    def test_multiline_qual(self, tmp_path):
        p = tmp_path / "m.fq"
        p.write_text("@r\nACGTAC\nGT\n+\nIIII\nIIII\n")
        recs = list(read_fastx(str(p)))
        assert recs == [("r", "ACGTACGT", "IIIIIIII")]
