"""End-to-end pipeline tests (the reference's CI smoke contract,
.travis.yml:33-36, plus output-file assertions it never had)."""

import os

import numpy as np
import pytest

from ngspeciesid.cli import main as cli_main
from ngspeciesid.io.fastx import read_fastx


def _fasta_seq(path):
    recs = list(read_fastx(path))
    assert len(recs) == 1
    return recs[0][1]


@pytest.mark.slow
class TestSampleH1:
    def test_consensus_medaka_class(self, tmp_path, sample_fastq):
        out = tmp_path / "out"
        rc = cli_main([
            "--ont", "--fastq", sample_fastq, "--outfolder", str(out),
            "--consensus", "--medaka", "--t", "1",
        ])
        assert rc == 0
        assert (out / "sorted.fastq").is_file()
        assert (out / "logfile.txt").is_file()
        assert (out / "final_clusters.tsv").is_file()
        assert (out / "final_cluster_origins.tsv").is_file()
        clusters = {}
        for line in open(out / "final_clusters.tsv"):
            cl, acc = line.split("\t")
            clusters.setdefault(cl, []).append(acc.strip())
        # sample_h1 is a single-barcode sample read in both orientations:
        # two dominant clusters (FW + RC), merged later by RC detection
        sizes = sorted((len(v) for v in clusters.values()), reverse=True)
        assert sizes[0] > 100 and sizes[0] + sizes[1] > 200
        # RC merge leaves ONE polished consensus with plausible COI length
        cons_files = list(out.glob("medaka_cl_id_*/consensus.fasta"))
        assert len(cons_files) == 1
        seq = _fasta_seq(str(cons_files[0]))
        assert 500 <= len(seq) <= 900
        assert set(seq) <= set("ACGT")
        # reads_to_consensus + consensus_reference written
        assert list(out.glob("consensus_reference_*.fasta"))
        assert list(out.glob("reads_to_consensus_*.fastq"))

    def test_consensus_racon_class_and_write_fastq(self, tmp_path, sample_fastq):
        out = tmp_path / "out"
        rc = cli_main([
            "--ont", "--fastq", sample_fastq, "--outfolder", str(out),
            "--consensus", "--racon", "--racon_iter", "2", "--t", "1",
        ])
        assert rc == 0
        cons_files = list(out.glob("racon_cl_id_*/consensus.fasta"))
        assert len(cons_files) >= 1
        seq = _fasta_seq(str(cons_files[0]))
        assert 500 <= len(seq) <= 900

        wf_out = tmp_path / "wf"
        rc = cli_main([
            "write_fastq", "--clusters", str(out / "final_clusters.tsv"),
            "--fastq", sample_fastq, "--outfolder", str(wf_out), "--N", "10",
        ])
        assert rc == 0
        files = list(wf_out.glob("*.fastq"))
        assert len(files) >= 1
        recs = list(read_fastx(str(files[0])))
        assert len(recs) >= 10

    def test_parallel_matches_merge_tree_outputs(self, tmp_path, sample_fastq):
        out = tmp_path / "out_t4"
        rc = cli_main([
            "--ont", "--fastq", sample_fastq, "--outfolder", str(out), "--t", "4",
        ])
        assert rc == 0
        # merge-tree schedule writes per-iteration dumps
        assert (out / "1" / "pre_clusters.csv").is_file()
        assert (out / "final_clusters.tsv").is_file()
        clusters = {}
        for line in open(out / "final_clusters.tsv"):
            cl, acc = line.split("\t")
            clusters.setdefault(cl, []).append(acc.strip())
        sizes = sorted((len(v) for v in clusters.values()), reverse=True)
        assert sizes[0] > 100 and sizes[0] + sizes[1] > 200


class TestMultiSpeciesAccuracy:
    """Simulated multi-species pool end-to-end: exactly one polished
    consensus per species, each within the <=1-edit BASELINE target of its
    template (best orientation — RC-merge keeps the bigger side's strand)."""

    def test_three_species_consensus(self, rng, tmp_path):
        from ngspeciesid.ops.edit import _dp_rows
        from ngspeciesid.utils.seqs import reverse_complement

        from .test_poa import make_template, noisy_copy

        n_per, length = 150, 450
        templates = [make_template(rng, length) for _ in range(3)]
        pool = tmp_path / "pool.fastq"
        with open(pool, "w") as f:
            i = 0
            for sp, t in enumerate(templates):
                for _ in range(n_per):
                    r, q = noisy_copy(rng, t, 0.07)
                    s = r.tobytes().decode()
                    qs = q.tobytes().decode()
                    if rng.random() < 0.5:
                        s = reverse_complement(s)
                        qs = qs[::-1]
                    f.write(f"@sim_{i}_sp{sp}\n{s}\n+\n{qs}\n")
                    i += 1
        out = tmp_path / "out"
        cli_main(["--ont", "--fastq", str(pool), "--outfolder", str(out),
                  "--consensus", "--medaka", "--t", "1"])
        import glob
        cons_files = sorted(glob.glob(str(out / "medaka_cl_id_*" / "consensus.fasta")))
        assert len(cons_files) == 3

        def ed(a, b):
            A = np.frombuffer(a.encode(), np.uint8)
            B = np.frombuffer(b.encode(), np.uint8)
            return int(_dp_rows(A, B, anchored=True)[B.size])

        matched = set()
        for cf in cons_files:
            seq = _fasta_seq(cf)
            d, j = min(
                (min(ed(seq, t.tobytes().decode()),
                     ed(seq, reverse_complement(t.tobytes().decode()))), j)
                for j, t in enumerate(templates))
            assert d <= 1, f"{cf}: {d} edits from nearest template"
            matched.add(j)
        assert matched == {0, 1, 2}


@pytest.mark.slow
class TestExitCodeContract:
    def test_cli_subprocess_exits_zero_on_default_platform(self, tmp_path, sample_fastq):
        """The CLI process must exit 0 after a successful --consensus run on
        whatever backend the machine defaults to (reference .travis.yml:33-36).

        Runs as a REAL subprocess with the conftest's JAX_PLATFORMS=cpu
        override removed, so on a GPU host it exercises the device DP and
        the process teardown after it.
        """
        import subprocess
        import sys

        env = dict(os.environ)
        env.pop("JAX_PLATFORMS", None)
        out = tmp_path / "out"
        proc = subprocess.run(
            [sys.executable, "-m", "ngspeciesid", "--ont",
             "--fastq", sample_fastq, "--outfolder", str(out),
             "--consensus", "--racon", "--t", "1"],
            env=env, capture_output=True, text=True, timeout=900,
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        )
        assert proc.returncode == 0, (
            f"CLI exited {proc.returncode}\nstderr tail:\n"
            + proc.stderr[-2000:])
        assert (out / "final_clusters.tsv").is_file()
