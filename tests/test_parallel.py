"""Multi-device sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

import jax

from ngspeciesid.config import Config
from ngspeciesid.ops.align import sg_align_batch


def rand_seq(rng, n):
    return rng.integers(65, 69, size=n).astype(np.uint8)


class TestMergeTreeOnVirtualShards:
    def test_shard_count_matches_cores(self, rng):
        # merge-tree clustering with nr_cores=8 on synthetic data mirrors the
        # reference's parallel path (schedule tested e2e in test_pipeline_e2e)
        from ngspeciesid.ops.score import batch_scores
        from ngspeciesid.utils.phred import qual_bytes
        from .test_cluster_engine import run_engine, simulate_reads, to_read_array
        from ngspeciesid.cluster.store import build_store
        from ngspeciesid.cluster.engine import GapPassTable
        from ngspeciesid.parallel.merge import merge_tree_clustering
        from ngspeciesid.utils.ptable import load_p_table, p_table_as_matrix

        records = simulate_reads(rng, n_templates=3, reads_per=12)
        read_array = to_read_array(records)
        cfg = Config(nr_cores=4, outfolder=None)
        p_matrix = p_table_as_matrix(load_p_table(13, 20))
        store = build_store(read_array, cfg.k, cfg.w)
        max_gap = max(c.size for c in store.min_codes)
        gap_table = GapPassTable(p_matrix, cfg.min_prob_no_hits, max_gap)
        import tempfile
        cfg.outfolder = tempfile.mkdtemp()
        clusters, alive = merge_tree_clustering(store, read_array, gap_table, cfg)
        # all reads accounted for
        total = sum(len(v) for v in clusters.values())
        assert total == len(read_array)
        sizes = sorted((len(v) for v in clusters.values()), reverse=True)
        assert sizes[0] >= 10  # templates still coalesce across shards
