#!/usr/bin/env python
"""Evaluate the GRU polisher against the deterministic pileup caller.

Grid: depth {10, 30, 100} x read error {5, 10, 15}% over simulated
amplicon clusters (draft from a noisier copy of the template, like
models/train.py).  For each cell, measure the edit distance of the
polished draft to the true template for:

  * det1 / det2 — one / two rounds of ops/poa.polish_round (the racon-class
    deterministic caller; two rounds = the --racon --racon_iter 2 default)
  * det+gru — polish_round then models/polisher.neural_polish_round with
    the given params (the --medaka_model GRU path in consensus/stage.py)

This is the prove-or-demote experiment for SURVEY.md N6 (reference
consensus.py:94-105): the table decides whether medaka model names map to
the GRU or to the deterministic caller.

Usage: python scripts/eval_polisher.py [--params ngspeciesid/data/polisher_gru.npz]
"""

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
sys.path.insert(0, ".")

from ngspeciesid.models.train import load_params, mutate
from ngspeciesid.models.polisher import neural_polish_round
from ngspeciesid.ops.poa import polish_round
from ngspeciesid.ops.edit import _dp_rows

ACGT = np.frombuffer(b"ACGT", dtype=np.uint8)


def edit(a: np.ndarray, b: np.ndarray) -> int:
    return int(_dp_rows(a, b, anchored=True)[b.size])


def run_grid(params, n_templates=8, tlen=600, e_draft=0.02, seed=0):
    rng = np.random.default_rng(seed)
    rows = []
    for depth in (10, 30, 100):
        for e_read in (0.05, 0.10, 0.15):
            d1 = d2 = dg = 0
            for _ in range(n_templates):
                template = ACGT[rng.integers(0, 4, size=tlen)]
                draft, _ = mutate(rng, template, e_draft)
                reads, quals = zip(*(mutate(rng, template, e_read)
                                     for _ in range(depth)))
                reads, quals = list(reads), list(quals)
                p1 = polish_round(draft, reads, quals)
                p2 = polish_round(p1, reads, quals)
                pg = neural_polish_round(params, p1, reads, quals) \
                    if params is not None else p1
                d1 += edit(p1, template)
                d2 += edit(p2, template)
                dg += edit(pg, template)
            rows.append((depth, e_read, d1 / n_templates, d2 / n_templates,
                         dg / n_templates))
    return rows


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--params",
                    default=os.path.join(os.path.dirname(__file__), "..",
                                         "ngspeciesid", "data",
                                         "polisher_gru.npz"))
    ap.add_argument("--n_templates", type=int, default=8)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    params = load_params(args.params) if os.path.isfile(args.params) else None
    rows = run_grid(params, n_templates=args.n_templates, seed=args.seed)
    print("depth\terr\tdet1\tdet2\tdet+gru  (mean edits to template)")
    for depth, e, d1, d2, dg in rows:
        print(f"{depth}\t{e:.2f}\t{d1:.2f}\t{d2:.2f}\t{dg:.2f}")
    worse = sum(1 for _, _, _, d2, dg in rows if dg > d2)
    print(f"\ncells where det+gru is worse than det2: {worse}/{len(rows)}")


if __name__ == "__main__":
    main()
