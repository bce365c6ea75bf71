"""Minimizer-anchor mapping (N4 minimap2 replacement) property tests."""

import numpy as np
import pytest

from ngspeciesid.ops.mapping import map_reads_to_center, write_paf
from ngspeciesid.utils.seqs import reverse_complement_bytes

from .test_poa import make_template, noisy_copy


class TestMapping:
    def test_forward_reads_map(self, rng):
        center = make_template(rng, 800)
        reads = [noisy_copy(rng, center, 0.1)[0] for _ in range(10)]
        maps = map_reads_to_center(center, reads)
        assert all(m is not None for m in maps)
        for m, r in zip(maps, reads):
            assert m.strand == "+"
            assert m.t_start < 150 and m.t_end > center.size - 150
            assert m.q_len == r.size
            assert 0 <= m.q_start < m.q_end <= m.q_len
            assert m.n_match <= m.block_len
            assert 0 <= m.mapq <= 60

    def test_rc_reads_get_minus_strand(self, rng):
        center = make_template(rng, 800)
        reads = [reverse_complement_bytes(noisy_copy(rng, center, 0.1)[0])
                 for _ in range(5)]
        maps = map_reads_to_center(center, reads)
        assert all(m is not None and m.strand == "-" for m in maps)

    def test_fragment_coordinates(self, rng):
        center = make_template(rng, 1000)
        frag = center[300:600].copy()
        (m,) = map_reads_to_center(center, [frag])
        assert m is not None and m.strand == "+"
        assert abs(m.t_start - 300) < 40
        assert abs(m.t_end - 600) < 40

    def test_unrelated_read_unmapped(self, rng):
        center = make_template(rng, 800)
        junk = make_template(rng, 700)
        (m,) = map_reads_to_center(center, [junk])
        assert m is None

    def test_paf_output(self, rng, tmp_path):
        center = make_template(rng, 600)
        reads = [noisy_copy(rng, center, 0.08)[0] for _ in range(4)]
        reads.append(make_template(rng, 500))  # unmapped
        maps = map_reads_to_center(center, reads)
        p = str(tmp_path / "m.paf")
        n = write_paf(p, [f"read{i}" for i in range(5)], maps, "center0")
        lines = open(p).read().splitlines()
        assert n == len(lines) == 4
        for ln in lines:
            fields = ln.split("\t")
            assert len(fields) == 12
            assert fields[4] in "+-"
            assert fields[5] == "center0"
            assert int(fields[9]) <= int(fields[10])


def test_batched_mapping_matches_per_read(rng):
    """map_reads_to_center's vectorized chain pass must reproduce the
    per-read map_read path field-for-field (including None verdicts and
    the '+'-wins-ties strand rule)."""
    from ngspeciesid.ops.mapping import map_read, map_reads_to_center
    from ngspeciesid.utils.seqs import reverse_complement_bytes

    acgt = np.frombuffer(b"ACGT", np.uint8)
    center = acgt[rng.integers(0, 4, 800)]
    reads = []
    for i in range(60):
        if i % 7 == 6:
            reads.append(acgt[rng.integers(0, 4, 300)])    # unrelated
            continue
        s, ln = int(rng.integers(0, 350)), int(rng.integers(300, 450))
        sub = center[s:s + ln].copy()
        keep = rng.random(sub.size) > 0.08
        sub = sub[keep]
        ins = rng.random(sub.size) < 0.04
        out = []
        for j, b in enumerate(sub):
            out.append(b)
            if ins[j]:
                out.append(acgt[rng.integers(0, 4)])
        r = np.array(out, np.uint8)
        if i % 3 == 0:
            r = reverse_complement_bytes(r)
        reads.append(r)
    from ngspeciesid.ops.minimizers import alphabet_ranks

    rank_of, rank_bits = alphabet_ranks(np.frombuffer(b"ACGT", np.uint8))
    got = map_reads_to_center(center, reads)
    for i, r in enumerate(reads):
        want = map_read(r, center, rank_of, rank_bits)
        if want is None:
            assert got[i] is None, f"read {i}"
        else:
            assert got[i] is not None, f"read {i}"
            assert got[i].__dict__ == want.__dict__, f"read {i}"
