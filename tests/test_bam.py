"""Pure-Python BAM reader (io/bam.py) against a hand-synthesized BAM."""

import gzip
import struct

import pytest

from ngspeciesid.io.bam import (
    FLAG_SECONDARY,
    FLAG_SUPPLEMENTARY,
    FLAG_UNMAPPED,
    classes_from_intervals,
    classes_from_ref_names,
    read_bam,
)


def _cigar(ops):
    """ops: list of (length, op_char)."""
    code = "MIDNSHP=X"
    return b"".join(struct.pack("<I", (ln << 4) | code.index(ch))
                    for ln, ch in ops)


def _record(qname, ref_id, pos, flag, cigar_ops, l_seq=0):
    name = qname.encode() + b"\x00"
    cig = _cigar(cigar_ops)
    body = struct.pack(
        "<iiBBHHHiiii", ref_id, pos, len(name), 30, 0,
        len(cigar_ops), flag, l_seq, -1, -1, 0,
    ) + name + cig
    return struct.pack("<i", len(body)) + body


def write_bam(path, refs, records, members=1):
    """refs: [(name, length)], records: raw record blobs.  `members` > 1
    splits the payload into multiple gzip members (BGZF-style)."""
    header = b"BAM\x01" + struct.pack("<i", 0)
    header += struct.pack("<i", len(refs))
    for name, length in refs:
        nm = name.encode() + b"\x00"
        header += struct.pack("<i", len(nm)) + nm + struct.pack("<i", length)
    payload = header + b"".join(records)
    chunk = max(1, len(payload) // members)
    with open(path, "wb") as f:
        for s in range(0, len(payload), chunk):
            f.write(gzip.compress(payload[s : s + chunk]))


@pytest.fixture
def bam_path(tmp_path):
    refs = [("speciesA", 10000), ("speciesB", 8000)]
    records = [
        _record("r1", 0, 100, 0, [(500, "M")]),                  # A:100-600
        _record("r2", 0, 400, 0, [(100, "M"), (50, "D"), (100, "M")]),  # A:400-650
        _record("r3", 0, 900, 0, [(300, "M"), (40, "I"), (10, "S")]),   # A:900-1200
        _record("r4", 1, 50, 0, [(200, "M"), (100, "N"), (100, "M")]),  # B:50-450
        _record("r2", 0, 5000, FLAG_SECONDARY, [(500, "M")]),    # ignored
        _record("r5", -1, -1, FLAG_UNMAPPED, []),                # ignored
        _record("r1", 1, 700, FLAG_SUPPLEMENTARY, [(90, "M")]),  # ignored
    ]
    p = str(tmp_path / "truth.bam")
    write_bam(p, refs, records, members=3)
    return p


class TestBamReader:
    def test_records_and_cigar_reference_span(self, bam_path):
        recs = list(read_bam(bam_path))
        assert len(recs) == 7
        by_name = {}
        for qname, flag, rname, start, end in recs:
            by_name.setdefault((qname, flag), (rname, start, end))
        assert by_name[("r1", 0)] == ("speciesA", 100, 600)
        # D consumes reference, I/S do not
        assert by_name[("r2", 0)] == ("speciesA", 400, 650)
        assert by_name[("r3", 0)] == ("speciesA", 900, 1200)
        # N consumes reference
        assert by_name[("r4", 0)] == ("speciesB", 50, 450)
        assert by_name[("r5", FLAG_UNMAPPED)] == (None, -1, -1)

    def test_bad_magic(self, tmp_path):
        p = str(tmp_path / "bad.bam")
        with open(p, "wb") as f:
            f.write(gzip.compress(b"notabam"))
        with pytest.raises(ValueError, match="magic"):
            list(read_bam(p))

    def test_ref_name_classes(self, bam_path):
        classes = classes_from_ref_names(bam_path)
        assert set(classes) == {"r1", "r2", "r3", "r4"}
        assert classes["r1"] == classes["r2"] == classes["r3"]
        assert classes["r4"] != classes["r1"]

    def test_interval_classes(self, bam_path):
        classes = classes_from_intervals(bam_path)
        # r1 and r2 overlap on speciesA; r3 is disjoint; r4 on speciesB
        assert classes["r1"] == classes["r2"]
        assert classes["r3"] != classes["r1"]
        assert classes["r4"] not in (classes["r1"], classes["r3"])

    def test_evaluator_integration(self, bam_path, tmp_path):
        from ngspeciesid.eval import evaluate

        classes = classes_from_ref_names(bam_path)
        clusters = {"r1": 0, "r2": 0, "r3": 0, "r4": 1}
        result = evaluate(classes, clusters)
        assert result["v_measure"] == pytest.approx(1.0)
        assert result["ari"] == pytest.approx(1.0)
