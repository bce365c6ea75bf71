#!/usr/bin/env python
"""Offline evaluation CLI: V-measure/ARI of inferred clusters vs truth.

Counterpart of the reference's scripts/compute_cluster_quality.py (C17).
Truth classes come from a TSV (``acc<TAB>class``) or from a BAM via the
pure-Python reader (ngspeciesid/io/bam.py): overlap-interval classes
for real data (reference :27-93) or reference-name classes with
--simulated (reference :96-101).  Metrics are computed by
ngspeciesid.eval.

Usage:
  python scripts/compute_cluster_quality.py --clusters final_clusters.tsv \
      --classes truth.tsv [--min_class_size 5] [--outfile q.csv]
"""

import argparse
import csv
import sys

sys.path.insert(0, ".")

from ngspeciesid.eval import evaluate, read_clusters_tsv


def read_classes_tsv(path):
    # first-seen integer ids (deterministic across runs, collision-free),
    # mirroring io/bam.py's class-id assignment
    out = {}
    ids = {}
    with open(path) as f:
        for line in f:
            items = line.strip().split("\t")
            if len(items) >= 2:
                out[items[0]] = ids.setdefault(items[1], len(ids))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--clusters", required=True)
    group = ap.add_mutually_exclusive_group(required=True)
    group.add_argument("--classes", help="TSV acc<TAB>class")
    group.add_argument("--classes_bam", help="truth BAM (pure-Python reader)")
    ap.add_argument("--simulated", action="store_true",
                    help="BAM classes from reference names (reference's "
                         "--simulated mode); default: overlap-interval classes")
    ap.add_argument("--min_class_size", type=int, default=0)
    ap.add_argument("--outfile", default=None)
    args = ap.parse_args()

    clusters = read_clusters_tsv(args.clusters)
    if args.classes:
        classes = read_classes_tsv(args.classes)
    else:
        from ngspeciesid.io.bam import (
            classes_from_intervals,
            classes_from_ref_names,
        )
        classes = (classes_from_ref_names(args.classes_bam) if args.simulated
                   else classes_from_intervals(args.classes_bam))
    result = evaluate(classes, clusters, args.min_class_size)
    if args.outfile:
        with open(args.outfile, "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(result.keys()))
            w.writeheader()
            w.writerow(result)
    for k, v in result.items():
        print(f"{k}\t{v}")


if __name__ == "__main__":
    main()
