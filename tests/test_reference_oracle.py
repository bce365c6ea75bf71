"""Differential tests against the ACTUAL reference implementation.

The reference at /root/reference is pure Python for stage 1 and — with
``parasail`` stubbed by our own DP — for the clustering stage, so it runs
in this image.  These tests import it READ-ONLY and assert byte-equality
of its outputs against ours on the same inputs (VERDICT.md round-2 next
item 3): the real reference is the oracle, not a hand-written restatement.

Reference call surfaces exercised:
  * modules/get_sorted_fastq_for_cluster.py:159-191 (stage 1)
  * modules/cluster.py:207-353 (reads_to_clusters) with parasail replaced
    by a shim over ops/align.sg_align_batch (cluster.py:132 consumes only
    ``.saturated`` and the decoded CIGAR)
  * NGSpeciesID:99-119 table writing (restated below, test-only)
"""

import importlib
import os
import sys
import types
from types import SimpleNamespace

import numpy as np
import pytest

REF = "/root/reference"
SAMPLE = os.path.join(REF, "test", "sample_h1.fastq")

pytestmark = pytest.mark.skipif(
    not os.path.isfile(SAMPLE), reason="reference checkout not present")


# ---------------------------------------------------------------------------
# parasail shim: the reference consumes .saturated + .cigar.decode (bytes)
# from sg_trace_scan_16/32 (cluster.py:130-147).  We serve the CIGAR of OUR
# DP's optimal path, so reference-with-shim vs our engine compares the
# surrounding clustering logic, not two different aligners.
# ---------------------------------------------------------------------------

def _moves_to_cigar(moves: np.ndarray, a: np.ndarray, b: np.ndarray) -> str:
    from ngspeciesid.ops.align import DIAG, UP

    i = j = 0
    ops = []
    for mv in moves:
        if mv == DIAG:
            ops.append("=" if a[i] == b[j] else "X")
            i += 1
            j += 1
        elif mv == UP:          # consumes s1 (query) only -> insertion
            ops.append("I")
            i += 1
        else:                   # consumes s2 (ref) only -> deletion
            ops.append("D")
            j += 1
    out = []
    prev, run = None, 0
    for op in ops:
        if op == prev:
            run += 1
        else:
            if prev is not None:
                out.append("%d%s" % (run, prev))
            prev, run = op, 1
    if prev is not None:
        out.append("%d%s" % (run, prev))
    return "".join(out)


def _parasail_stub() -> types.ModuleType:
    mod = types.ModuleType("parasail")

    class _Cigar:
        def __init__(self, s: str):
            self.decode = s.encode()

    class _Result:
        saturated = False

        def __init__(self, cigar: str, score: int):
            self.cigar = _Cigar(cigar)
            self.score = score

    def matrix_create(alphabet, match, mismatch):
        return (int(match), int(mismatch))

    def sg_trace_scan_16(s1, s2, gap_open, gap_ext, matrix):
        from ngspeciesid.ops.align import DIAG, LEFT, UP, sg_align_batch

        match, mismatch = matrix
        a = np.frombuffer(s1.encode(), np.uint8)
        b = np.frombuffer(s2.encode(), np.uint8)
        moves = sg_align_batch([(a, b)], [int(gap_open)], match=match,
                               mismatch=mismatch, gap_ext=int(gap_ext))[0]
        # score of the semi-global path: internal columns only
        nz = np.flatnonzero(moves == DIAG)
        if nz.size == 0:
            score = 0
        else:
            lo, hi = nz[0], nz[-1] + 1
            i = np.cumsum(moves != LEFT)
            j = np.cumsum(moves != UP)
            inner = moves[lo:hi]
            di = np.flatnonzero(inner == DIAG) + lo
            nmatch = int((a[i[di] - 1] == b[j[di] - 1]).sum())
            nmis = di.size - nmatch
            score = nmatch * match + nmis * mismatch
            gaps = np.flatnonzero(inner != DIAG)
            if gaps.size:
                runs = 1 + int((np.diff(gaps) > 1).sum())
                # mixed adjacent I/D runs each open separately
                runs += int((np.diff(inner[gaps][np.argsort(gaps)]) != 0).sum())
                score -= runs * int(gap_open) + (gaps.size - runs) * int(gap_ext)
        return _Result(_moves_to_cigar(moves, a, b), score)

    mod.matrix_create = matrix_create
    mod.sg_trace_scan_16 = sg_trace_scan_16
    mod.sg_trace_scan_32 = sg_trace_scan_16
    return mod


@pytest.fixture(scope="module")
def ref():
    """Import the reference modules read-only with parasail shimmed."""
    had = sys.modules.get("parasail")
    sys.modules["parasail"] = _parasail_stub()
    sys.path.insert(0, REF)
    try:
        mods = SimpleNamespace(
            cluster=importlib.import_module("modules.cluster"),
            get_sorted=importlib.import_module(
                "modules.get_sorted_fastq_for_cluster"),
            helpf=importlib.import_module("modules.help_functions"),
            ptab=importlib.import_module("modules.p_minimizers_shared"),
        )
    finally:
        sys.path.remove(REF)
        if had is not None:
            sys.modules["parasail"] = had
    return mods


def _simulated_pool(rng, path, n_per=60, length=420, n_species=2, err=0.08):
    from ngspeciesid.utils.seqs import reverse_complement

    from .test_poa import make_template, noisy_copy

    with open(path, "w") as f:
        i = 0
        for sp in range(n_species):
            t = make_template(rng, length)
            for _ in range(n_per):
                r, q = noisy_copy(rng, t, err)
                s = r.tobytes().decode()
                qs = q.tobytes().decode()
                if rng.random() < 0.5:
                    s = reverse_complement(s)
                    qs = qs[::-1]
                f.write("@sim_%d_sp%d\n%s\n+\n%s\n" % (i, sp, s, qs))
                i += 1


class TestStage1AgainstReference:
    def _run_both(self, ref, tmp_path, fastq):
        ref_out = tmp_path / "ref"
        ref_out.mkdir()
        args = SimpleNamespace(
            outfolder=str(ref_out), outfile=str(ref_out / "sorted.fastq"),
            use_old_sorted_file=False, fastq=fastq, nr_cores=1,
            quality_threshold=7.0, k=13)
        ref.get_sorted.main(args)

        from ngspeciesid.config import Config
        from ngspeciesid.preprocess import score_and_sort

        our_out = tmp_path / "ours"
        our_out.mkdir()
        cfg = Config(fastq=fastq, outfolder=str(our_out), nr_cores=1)
        cfg.apply_preset(ont=True)
        ours = score_and_sort(cfg)
        with open(ours, "rb") as f1, open(ref_out / "sorted.fastq", "rb") as f2:
            a, b = f1.read(), f2.read()
        assert len(a) == len(b)
        assert a == b

    def test_sample_h1_byte_identical(self, ref, tmp_path):
        self._run_both(ref, tmp_path, SAMPLE)

    def test_simulated_pool_byte_identical(self, ref, tmp_path, rng):
        pool = tmp_path / "pool.fastq"
        _simulated_pool(rng, pool)
        self._run_both(ref, tmp_path, str(pool))


class TestClusteringAgainstReference:
    def _run_both(self, ref, tmp_path, fastq):
        from ngspeciesid.cli import main as cli_main

        out = tmp_path / "ours"
        rc = cli_main(["--ont", "--fastq", fastq, "--outfolder", str(out),
                       "--t", "1"])
        assert rc == 0

        # reference clustering over the SAME sorted file (stage-1 parity is
        # asserted by TestStage1AgainstReference)
        sorted_fq = str(out / "sorted.fastq")
        read_array = [
            (i, 0, acc, seq, qual, float(acc.split("_")[-1]))
            for i, (acc, (seq, qual)) in enumerate(
                ref.helpf.readfq(open(sorted_fq, "r")))]
        p_emp_probs = {}
        for k, w, p, e1, e2 in ref.ptab.read_empirical_p():
            if int(k) == 13 and abs(int(w) - 20) <= 2:
                p_emp_probs[(float(e1), float(e2))] = float(p)
                p_emp_probs[(float(e2), float(e1))] = float(p)
        args = SimpleNamespace(
            k=13, w=20, min_shared=5, mapped_threshold=0.7,
            aligned_threshold=0.4, min_fraction=0.8, min_prob_no_hits=0.1,
            symmetric_map_align_thresholds=False, print_output=10000)
        clusters = {i: [acc] for i, _, acc, _, _, _ in read_array}
        representatives = {r[0]: r for r in read_array}
        result = ref.cluster.reads_to_clusters(
            clusters, representatives, read_array, p_emp_probs, {}, 1, args)
        clusters, representatives, _, _ = list(result.values())[0]

        # the reference's table-writing loop (NGSpeciesID:99-119), restated
        # here test-only to produce its exact bytes
        ref_dir = tmp_path / "ref"
        ref_dir.mkdir()
        with open(ref_dir / "final_clusters.tsv", "w") as outfile, \
                open(ref_dir / "final_cluster_origins.tsv", "w") as origins:
            output_cl_id = 0
            for c_id, all_read_acc in sorted(
                    clusters.items(),
                    key=lambda x: (len(x[1]), representatives[x[0]][5]),
                    reverse=True):
                _, _, acc, c_seq, c_qual, score, error_rate, _ = \
                    representatives[c_id]
                origins.write("{0}\t{1}\t{2}\t{3}\t{4}\t{5}\n".format(
                    output_cl_id, "_".join(acc.split("_")[:-1]), c_seq,
                    c_qual, score, error_rate))
                for r_acc in sorted(all_read_acc,
                                    key=lambda x: float(x.split("_")[-1]),
                                    reverse=True):
                    outfile.write("{0}\t{1}\n".format(
                        output_cl_id, "_".join(r_acc.split("_")[:-1])))
                output_cl_id += 1

        with open(out / "final_clusters.tsv", "rb") as f1, \
                open(ref_dir / "final_clusters.tsv", "rb") as f2:
            assert f1.read() == f2.read(), \
                "final_clusters.tsv differs from the executed reference"
        # origins: every column byte-exact EXCEPT error_rate, which the
        # reference sums over set(qual) (cluster.py:283-291) — set order
        # depends on the randomized string hash, so its last ulp is not
        # stable even between two runs of the reference itself.  Compare
        # that one column to ulp-level relative tolerance instead.
        with open(out / "final_cluster_origins.tsv") as f1, \
                open(ref_dir / "final_cluster_origins.tsv") as f2:
            ours_lines, ref_lines = f1.readlines(), f2.readlines()
        assert len(ours_lines) == len(ref_lines)
        for lo, lr in zip(ours_lines, ref_lines):
            co, cr = lo.rstrip("\n").split("\t"), lr.rstrip("\n").split("\t")
            assert co[:5] == cr[:5]
            assert float(co[5]) == pytest.approx(float(cr[5]), rel=1e-12)

    def test_sample_h1_tables_byte_identical(self, ref, tmp_path):
        self._run_both(ref, tmp_path, SAMPLE)

    def test_simulated_pool_tables_byte_identical(self, ref, tmp_path, rng):
        pool = tmp_path / "pool.fastq"
        _simulated_pool(rng, pool, n_per=40, length=380, n_species=3)
        self._run_both(ref, tmp_path, str(pool))
