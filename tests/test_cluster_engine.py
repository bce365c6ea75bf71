"""Differential tests: wave-batched clustering engine vs sequential oracle."""

import numpy as np
import pytest

from ngspeciesid.config import Config
from ngspeciesid.cluster.engine import GapPassTable, reads_to_clusters
from ngspeciesid.cluster.store import build_store
from ngspeciesid.ops.score import batch_scores
from ngspeciesid.utils.ptable import load_p_table, p_table_as_matrix
from ngspeciesid.utils.phred import qual_bytes

from .oracle.cluster import cluster_reads as oracle_cluster


@pytest.fixture(scope="module")
def p_emp():
    return load_p_table(13, 20)


@pytest.fixture(scope="module")
def p_matrix(p_emp):
    return p_table_as_matrix(p_emp)


def simulate_reads(rng, n_templates=4, reads_per=12, tlen=400, err=0.07):
    """ONT-ish synthetic reads from random templates."""
    templates = [
        "".join("ACGT"[c] for c in rng.integers(0, 4, size=tlen))
        for _ in range(n_templates)
    ]
    records = []
    for t_i, t in enumerate(templates):
        for r_i in range(reads_per):
            out = []
            for ch in t:
                r = rng.random()
                if r < err / 3:
                    continue
                out.append(ch)
                if r < 2 * err / 3:
                    out.append("ACGT"[rng.integers(0, 4)])
                elif r < err:
                    out[-1] = "ACGT"[rng.integers(0, 4)]
            seq = "".join(out)
            qual = "".join(chr(int(q)) for q in rng.integers(33 + 8, 33 + 25, size=len(seq)))
            records.append((f"t{t_i}r{r_i}", seq, qual))
    return records


def to_read_array(records, k=13):
    scores = batch_scores([qual_bytes(q) for _, _, q in records], k)
    order = np.argsort(-scores, kind="stable")
    return [
        (i, 0, f"{records[j][0]}_{float(scores[j])!r}", records[j][1], records[j][2],
         float(scores[j]))
        for i, j in enumerate(order)
    ]


def run_engine(read_array, p_matrix, cfg):
    store = build_store(read_array, cfg.k, cfg.w)
    clusters = {i: [acc] for i, _, acc, _, _, _ in read_array}
    max_gap = max((c.size for c in store.min_codes), default=1)
    gap_table = GapPassTable(p_matrix, cfg.min_prob_no_hits, max_gap)
    clusters, alive, db = reads_to_clusters(
        store, clusters, np.arange(len(read_array)), gap_table, cfg
    )
    return clusters, set(alive)


class TestEngineVsOracle:
    @pytest.mark.parametrize("wave_size", [1, 5, 64])
    def test_matches_oracle(self, rng, p_emp, p_matrix, wave_size):
        records = simulate_reads(rng)
        read_array = to_read_array(records)
        cfg = Config(wave_size=wave_size, align_band=0)  # oracle is full-DP
        want_clusters, want_reps = oracle_cluster(read_array, p_emp, cfg)
        got_clusters, got_reps = run_engine(read_array, p_matrix, cfg)
        assert got_reps == want_reps
        assert got_clusters == want_clusters

    def test_wave_invariance(self, rng, p_matrix):
        records = simulate_reads(rng, n_templates=3, reads_per=20, err=0.1)
        read_array = to_read_array(records)
        results = []
        for ws in (1, 3, 17, 256):
            cfg = Config(wave_size=ws)
            results.append(run_engine(read_array, p_matrix, cfg))
        for r in results[1:]:
            assert r == results[0]

    def test_band_matches_full_dp(self, rng, p_matrix):
        # default banded fallback alignments give the same clusters as the
        # reference-exact full DP on same-template reads
        records = simulate_reads(rng, n_templates=3, reads_per=15, err=0.09)
        read_array = to_read_array(records)
        full = run_engine(read_array, p_matrix, Config(align_band=0))
        banded = run_engine(read_array, p_matrix, Config(align_band=150))
        assert full == banded

    def test_symmetric_thresholds(self, rng, p_emp, p_matrix):
        records = simulate_reads(rng, n_templates=2, reads_per=10)
        read_array = to_read_array(records)
        cfg = Config(wave_size=8, symmetric_map_align_thresholds=True,
                     align_band=0)
        want = oracle_cluster(read_array, p_emp, cfg)
        got = run_engine(read_array, p_matrix, cfg)
        assert got[0] == want[0]

    def test_templates_split(self, rng, p_matrix):
        # sanity: distinct templates should mostly form distinct clusters
        records = simulate_reads(rng, n_templates=3, reads_per=15, err=0.05)
        read_array = to_read_array(records)
        clusters, reps = run_engine(read_array, p_matrix, Config(wave_size=64))
        big = [accs for accs in clusters.values() if len(accs) >= 5]
        assert len(big) == 3
        for accs in big:
            tpl = {acc.split("r")[0] for acc in accs}
            assert len(tpl) == 1  # no template mixing

    def test_tiny_inputs(self, p_matrix):
        read_array = [(0, 0, "a_1.0", "ACGTACGTACGTACGTACGTACGTACG", "I" * 27, 1.0)]
        clusters, reps = run_engine(read_array, p_matrix, Config())
        assert clusters == {0: ["a_1.0"]}
