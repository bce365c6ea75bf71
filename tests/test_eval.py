"""Cluster-quality metric tests (cross-checked against sklearn)."""

import numpy as np
import pytest

from ngspeciesid.eval import (
    adjusted_rand_index,
    cluster_size_stats,
    evaluate,
    homogeneity_completeness_v,
    with_singleton_fill,
)


class TestMetricsVsSklearn:
    def test_random_labelings(self, rng):
        from sklearn.metrics import (
            adjusted_rand_score,
            homogeneity_completeness_v_measure,
        )
        for _ in range(20):
            n = int(rng.integers(5, 200))
            lt = rng.integers(0, 6, size=n).tolist()
            lp = rng.integers(0, 8, size=n).tolist()
            hom, com, v = homogeneity_completeness_v(lt, lp)
            s_hom, s_com, s_v = homogeneity_completeness_v_measure(lt, lp)
            assert hom == pytest.approx(s_hom, abs=1e-10)
            assert com == pytest.approx(s_com, abs=1e-10)
            assert v == pytest.approx(s_v, abs=1e-10)
            assert adjusted_rand_index(lt, lp) == pytest.approx(
                adjusted_rand_score(lt, lp), abs=1e-10)

    def test_perfect_clustering(self):
        lt = [0, 0, 1, 1, 2]
        hom, com, v = homogeneity_completeness_v(lt, lt)
        assert (hom, com, v) == (1.0, 1.0, 1.0)
        assert adjusted_rand_index(lt, lt) == 1.0


class TestHelpers:
    def test_singleton_fill(self):
        classes = {"a": 0, "b": 0, "c": 1}
        clusters = {"a": 5, "b": 5}
        lt, lp = with_singleton_fill(classes, clusters)
        assert lt == [0, 0, 1]
        assert lp[0] == lp[1] == 5
        assert lp[2] not in (5,)

    def test_n50_and_esize(self):
        stats = cluster_size_stats([50, 30, 20])
        assert stats["n50"] == 50
        assert stats["e_size"] == pytest.approx((2500 + 900 + 400) / 100)
        assert stats["max"] == 50 and stats["min"] == 20

    def test_evaluate_min_class_size(self):
        classes = {f"r{i}": 0 for i in range(10)}
        classes.update({"x": 1})  # singleton class dropped at min size 5
        clusters = {f"r{i}": 0 for i in range(10)}
        res = evaluate(classes, clusters, min_class_size=5)
        assert res["v_measure"] == 1.0
        assert res["n_clusters"] == 1
