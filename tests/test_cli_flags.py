"""CLI surface and pipeline-flag behaviour tests."""

import numpy as np
import pytest

from ngspeciesid.cli import args_to_config, build_parser
from ngspeciesid.config import Config
from ngspeciesid.io.fastx import read_fastx
from ngspeciesid.pipeline import load_read_array
from ngspeciesid.parallel.merge import batch_list
from ngspeciesid.preprocess import score_and_sort


def _mk_fastq(tmp_path, rng, n=30, lmin=100, lmax=400):
    p = tmp_path / "in.fastq"
    with open(p, "w") as f:
        for i in range(n):
            ln = int(rng.integers(lmin, lmax))
            seq = "".join("ACGT"[c] for c in rng.integers(0, 4, size=ln))
            qual = "".join(chr(int(q)) for q in rng.integers(33 + 12, 33 + 30, size=ln))
            f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
    return str(p)


class TestParser:
    def test_presets(self):
        p = build_parser()
        cfg = args_to_config(p.parse_args(["--isoseq", "--fastq", "x", "--outfolder", "o"]))
        assert (cfg.k, cfg.w) == (15, 50)
        cfg = args_to_config(p.parse_args(["--ont", "--fastq", "x", "--outfolder", "o"]))
        assert (cfg.k, cfg.w) == (13, 20)

    def test_defaults_match_reference(self):
        p = build_parser()
        cfg = args_to_config(p.parse_args(["--fastq", "x", "--outfolder", "o"]))
        assert cfg.nr_cores == 8 and cfg.quality_threshold == 7.0
        assert cfg.k == 13 and cfg.w == 20 and cfg.min_shared == 5
        assert cfg.mapped_threshold == 0.7 and cfg.aligned_threshold == 0.4
        assert cfg.min_fraction == 0.8 and cfg.min_prob_no_hits == 0.1
        assert cfg.abundance_ratio == 0.1 and cfg.rc_identity_threshold == 0.9
        assert cfg.max_seqs_for_consensus == -1 and cfg.racon_iter == 2
        assert cfg.primer_max_ed == 2 and cfg.trim_window == 150
        assert cfg.batch_type == "total_nt"

    def test_mutually_exclusive_polishers(self):
        p = build_parser()
        with pytest.raises(SystemExit):
            p.parse_args(["--fastq", "x", "--medaka", "--racon"])

    def test_validation_w_less_than_k(self):
        from ngspeciesid.cli import main
        assert main(["--fastq", "x", "--outfolder", "o", "--k", "30", "--w", "20"]) == 1

    def test_extension_flags(self):
        p = build_parser()
        cfg = args_to_config(p.parse_args(
            ["--fastq", "x", "--outfolder", "o", "--resume", "--profile"]))
        assert cfg.resume and cfg.profile
        cfg = args_to_config(p.parse_args(["--fastq", "x", "--outfolder", "o"]))
        assert not cfg.resume and not cfg.profile


class TestFilters:
    def test_length_window(self, tmp_path, rng):
        fq = _mk_fastq(tmp_path, rng, n=40, lmin=100, lmax=400)
        cfg = Config(fastq=fq, outfolder=str(tmp_path))
        sp = score_and_sort(cfg)
        cfg.target_length, cfg.target_deviation = 250, 50
        ra = load_read_array(sp, cfg)
        assert all(200 <= len(seq) <= 300 for _, _, _, seq, _, _ in ra)

    def test_sample_size_random_and_top(self, tmp_path, rng):
        fq = _mk_fastq(tmp_path, rng)
        cfg = Config(fastq=fq, outfolder=str(tmp_path), sample_size=10)
        sp = score_and_sort(cfg)
        ra = load_read_array(sp, cfg)
        assert len(ra) == 10
        full = load_read_array(sp, Config(fastq=fq, outfolder=str(tmp_path)))
        cfg.top_reads = True
        top = load_read_array(sp, cfg)
        assert len(top) == 10
        assert [r[2] for r in top] == [r[2] for r in full[:10]]
        # seeded sampling is reproducible
        again = load_read_array(sp, Config(fastq=fq, outfolder=str(tmp_path), sample_size=10))
        ra_accs = [r[2] for r in ra]
        assert [r[2] for r in again] == ra_accs


class TestBatchList:
    def _reads(self, rng, n=20):
        return [(i, 0, f"a{i}", "A" * int(rng.integers(50, 300)), "I", 1.0)
                for i in range(n)]

    def test_nr_reads(self, rng):
        reads = self._reads(rng)
        batches = list(batch_list(reads, 4, "nr_reads"))
        assert sum(len(b) for b in batches) == 20

    def test_total_nt_balances(self, rng):
        reads = self._reads(rng, 40)
        batches = [b for b in batch_list(reads, 4, "total_nt") if b]
        tot = [sum(len(r[3]) for r in b) for b in batches]
        assert sum(len(b) for b in batches) == 40
        assert max(tot) < 2 * (sum(tot) / len(tot) + 300)

    def test_read_lengths_squared(self, rng):
        reads = self._reads(rng, 40)
        batches = [b for b in batch_list(reads, 4, "read_lengths_squared") if b]
        assert sum(len(b) for b in batches) == 40

    def test_unknown_type_raises(self, rng):
        with pytest.raises(ValueError):
            list(batch_list(self._reads(rng), 4, "weighted"))

    def test_merge_consecutive_pairs(self):
        # reads sorted by score; batch ids 1..4 -> pairs (1,2), (3,4)
        reads = [(i, 1 + i // 5, f"a{i}", "A" * 100, "I", float(20 - i))
                 for i in range(20)]
        merged = list(batch_list(reads, merge_consecutive=True))
        assert len(merged) == 2
        assert {r[1] for r in merged[0]} == {1, 2}
        assert {r[1] for r in merged[1]} == {3, 4}


class TestMedakaFastqOutput:
    def test_fastq_flag_writes_fastq(self, tmp_path, rng):
        from ngspeciesid.cli import main
        # clusterable reads: noisy copies of one template
        template = "".join("ACGT"[c] for c in rng.integers(0, 4, size=300))
        fq = tmp_path / "in.fastq"
        with open(fq, "w") as f:
            for i in range(30):
                seq = "".join(
                    ch for ch in template if rng.random() > 0.02)
                qual = "".join(chr(int(q)) for q in rng.integers(45, 63, size=len(seq)))
                f.write(f"@r{i}\n{seq}\n+\n{qual}\n")
        fq = str(fq)
        out = tmp_path / "o"
        rc = main(["--ont", "--fastq", fq, "--outfolder", str(out),
                   "--consensus", "--medaka", "--medaka_fastq", "--t", "1"])
        assert rc == 0
        fastqs = list(out.glob("medaka_cl_id_*/consensus.fastq"))
        fastas = list(out.glob("medaka_cl_id_*/consensus.fasta"))
        assert fastqs and not fastas
