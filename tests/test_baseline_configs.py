"""End-to-end runs of the BASELINE.json workload shapes (2 and 4) on
simulated multi-species pools, scored against ground truth."""

import subprocess
import sys

import numpy as np
import pytest

from ngspeciesid.cli import main as cli_main
from ngspeciesid.eval import evaluate, read_clusters_tsv
from ngspeciesid.io.fastx import read_fastx


@pytest.fixture(scope="module")
def species_pool(tmp_path_factory):
    d = tmp_path_factory.mktemp("pool")
    out = d / "pool.fastq"
    truth = d / "truth.tsv"
    subprocess.run(
        [sys.executable, "scripts/simulate_reads.py", "--out", str(out),
         "--n_reads", "600", "--n_species", "3", "--length", "700",
         "--error", "0.06", "--truth_out", str(truth),
         "--primer_file", "/root/reference/test/Supplementary_File3_primer.txt"],
        check=True, cwd="/root/repo",
    )
    return str(out), str(truth)


@pytest.mark.slow
class TestMultiSpeciesConfigs:
    def test_primer_trimmed_consensus(self, tmp_path, species_pool):
        """BASELINE config 2: multi-species pool + primer trimming + consensus."""
        pool, truth_path = species_pool
        out = tmp_path / "o"
        rc = cli_main([
            "--ont", "--fastq", pool, "--outfolder", str(out),
            "--consensus", "--racon", "--t", "1",
            "--primer_file", "/root/reference/test/Supplementary_File3_primer.txt",
        ])
        assert rc == 0
        # 3 species -> 3 polished consensuses after RC merge
        cons = list(out.glob("racon_cl_id_*/consensus.fasta"))
        assert len(cons) == 3
        # primers trimmed: consensus shorter than template+primers
        for c in cons:
            seq = open(c).read().splitlines()[1]
            assert 600 <= len(seq) <= 760
        # clustering quality vs truth
        truth = {}
        for line in open(truth_path):
            acc, sp = line.split()
            truth[acc] = int(sp)
        clusters = read_clusters_tsv(str(out / "final_clusters.tsv"))
        res = evaluate(truth, clusters)
        # each species yields one FW + one RC cluster (merged only at the
        # center level), capping completeness near 1 - ln2/ln6 ~ 0.61
        assert res["completeness"] > 0.55
        assert res["homogeneity"] > 0.97

    def test_subsample_and_length_filter(self, tmp_path, species_pool):
        """BASELINE config 4: --sample_size 300 --m 750 --s 80."""
        pool, _ = species_pool
        out = tmp_path / "o"
        rc = cli_main([
            "--ont", "--fastq", pool, "--outfolder", str(out),
            "--consensus", "--medaka", "--t", "1",
            "--sample_size", "300", "--m", "750", "--s", "80",
        ])
        assert rc == 0
        assert (out / "final_clusters.tsv").is_file()
        n_assigned = sum(1 for _ in open(out / "final_clusters.tsv"))
        assert n_assigned <= 300
        cons = list(out.glob("medaka_cl_id_*/consensus.fasta"))
        assert 1 <= len(cons) <= 6

    def test_merge_tree_multispecies(self, tmp_path, species_pool):
        """Sharded merge-tree schedule on a multi-species pool."""
        pool, truth_path = species_pool
        out = tmp_path / "o"
        rc = cli_main(["--ont", "--fastq", pool, "--outfolder", str(out), "--t", "4"])
        assert rc == 0
        truth = {}
        for line in open(truth_path):
            acc, sp = line.split()
            truth[acc] = int(sp)
        clusters = read_clusters_tsv(str(out / "final_clusters.tsv"))
        res = evaluate(truth, clusters)
        assert res["homogeneity"] > 0.97
        assert res["completeness"] > 0.55
