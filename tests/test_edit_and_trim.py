"""Infix edit-distance search and primer/tail trimming tests."""

import numpy as np
import pytest

from ngspeciesid.config import Config
from ngspeciesid.ops.edit import IUPAC_PAIRS, infix_search
from ngspeciesid.consensus.stage import (
    find_barcode_locations,
    get_universal_tails,
    read_barcodes,
    remove_barcodes,
)
from ngspeciesid.utils.seqs import reverse_complement, seq_bytes


def brute_force_infix(query: str, target: str, eq) -> int:
    """min edit distance of query vs ANY substring of target (O(m^2 n))."""
    import functools

    @functools.lru_cache(maxsize=None)
    def lev(qi, s, e):
        # distance of query[:qi] vs target[s:e], recursive
        if qi == 0:
            return e - s
        if s == e:
            return qi
        sub = 0 if eq(query[qi - 1], target[e - 1]) else 1
        return min(lev(qi - 1, s, e - 1) + sub,
                   lev(qi - 1, s, e) + 1,
                   lev(qi, s, e - 1) + 1)

    m = len(target)
    best = len(query)
    for e in range(0, m + 1):
        for s in range(0, e + 1):
            best = min(best, lev(len(query), s, e))
    return best


def _eq(a, b):
    if a == b:
        return True
    return (a, b) in IUPAC_PAIRS or (b, a) in IUPAC_PAIRS


class TestInfixSearch:
    def test_exact_hit(self):
        res = infix_search(seq_bytes("ACGTAC"), seq_bytes("TTTTACGTACTTTT"), 2)
        assert res == (4, 9, 0)

    def test_one_error(self):
        res = infix_search(seq_bytes("ACGTAC"), seq_bytes("TTTTACCTACTTTT"), 2)
        assert res is not None
        start, end, ed = res
        assert ed == 1

    def test_no_hit_above_k(self):
        assert infix_search(seq_bytes("AAAAAAA"), seq_bytes("CCCCCCCCCC"), 2) is None

    def test_iupac_wildcards(self):
        # N matches anything, Y matches C/T
        res = infix_search(seq_bytes("ANYT"), seq_bytes("GGGACTTGGG"), 0)
        assert res is not None
        assert res[2] == 0

    def test_vs_brute_force(self, rng):
        for _ in range(25):
            q = "".join("ACGT"[c] for c in rng.integers(0, 4, size=int(rng.integers(3, 8))))
            t = "".join("ACGT"[c] for c in rng.integers(0, 4, size=int(rng.integers(5, 20))))
            want = brute_force_infix(q, t, _eq)
            got = infix_search(seq_bytes(q), seq_bytes(t), max_ed=len(q))
            assert got is not None
            assert got[2] == want, (q, t)


class TestTrimming:
    def test_universal_tails(self):
        tails = get_universal_tails()
        assert tails["1_F_fw"] == "TTTCTGTTGGTGCTGATATTGC"
        assert tails["1_F_rc"] == reverse_complement(tails["1_F_fw"])
        core = "".join("ACGT"[i % 4] for i in range(400))
        center = tails["1_F_fw"] + core + tails["2_R_rc"]
        centers = [[10, 0, center, "path"]]
        cfg = Config(trim_window=150, primer_max_ed=2)
        updated = remove_barcodes(centers, tails, cfg)
        assert updated
        trimmed = centers[0][2]
        assert len(trimmed) < len(center)
        assert core[50:350] in trimmed  # interior untouched

    def test_reference_primer_file(self):
        import os
        path = "/root/reference/test/Supplementary_File3_primer.txt"
        if not os.path.isfile(path):
            pytest.skip("reference primer fasta not available")
        barcodes = read_barcodes(path)
        # _fw and _rc entries for every primer
        fw = [k for k in barcodes if k.endswith("_fw")]
        rc = [k for k in barcodes if k.endswith("_rc")]
        assert len(fw) == len(rc) and len(fw) >= 2
        for k in fw:
            assert barcodes[k[:-3] + "_rc"] == reverse_complement(barcodes[k].upper())
        # plant a primer at the start of a synthetic center and trim it
        primer = barcodes[fw[0]].upper().replace("W", "A").replace("Y", "C") \
            .replace("R", "A").replace("K", "G").replace("M", "A").replace("S", "C") \
            .replace("N", "A").replace("H", "A").replace("D", "A").replace("B", "C") \
            .replace("V", "A")
        core = "".join("ACGT"[i % 4] for i in range(500))
        centers = [[10, 0, primer + core, "p"]]
        cfg = Config()
        assert remove_barcodes(centers, barcodes, cfg)
        assert not centers[0][2].startswith(primer[:10])

    def test_short_center_window_halved(self):
        tails = get_universal_tails()
        center = tails["1_F_fw"] + "ACGT" * 20 + tails["2_R_rc"]  # < 2*150
        centers = [[5, 1, center, "p"]]
        cfg = Config(trim_window=150)
        remove_barcodes(centers, tails, cfg)
        assert len(centers[0][2]) <= len(center)

    def test_find_barcode_locations_reports_all(self):
        tails = get_universal_tails()
        center = tails["1_F_fw"] + "A" * 100
        hits = find_barcode_locations(center, tails, 2)
        assert any(acc == "1_F_fw" for acc, _, _, _ in hits)
