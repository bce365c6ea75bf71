"""Sequential clustering oracle (test-only).

A direct, loop-based implementation of the reference's greedy clustering
control flow (SURVEY.md C4/C5/C7/C8; reference cluster.py:207-353), used to
differential-test the wave-batched engine.  It shares the alignment backend
(ngspeciesid.ops.align) with the engine so that any disagreement isolates
the orchestration, not DP tie-breaking.
"""

import math
from collections import defaultdict
from functools import reduce
from operator import mul

import numpy as np

from ngspeciesid.ops.align import block_aligned_stats, match_vector, sg_align_numpy
from ngspeciesid.utils.phred import PHRED_TO_P_CAPPED
from ngspeciesid.utils.seqs import seq_bytes

from .minimizers import minimizers as get_minimizers
from .stage1 import hpol_compress


def phred_p_capped(c):
    return float(PHRED_TO_P_CAPPED[ord(c)])


def hpol_error_rate(seq, qual):
    comp_q = []
    i = 0
    while i < len(seq):
        j = i
        while j < len(seq) and seq[j] == seq[i]:
            j += 1
        comp_q.append(min(qual[i:j], key=phred_p_capped))
        i = j
    pm = sum(comp_q.count(c) * phred_p_capped(c) for c in sorted(set(comp_q)))
    return pm / len(comp_q)


def full_error_rate(seq, qual):
    pm = sum(qual.count(c) * phred_p_capped(c) for c in sorted(set(qual)))
    return pm / len(seq)


def p_shared(e1, e2, p_emp):
    def clamp(e):
        e = round(e, 2)
        return min(max(e, 0.01), 0.15)
    return p_emp[(clamp(e1), clamp(e2))]


def block_align(s1, s2, k, match_id, gap_open):
    moves = sg_align_numpy(seq_bytes(s1), seq_bytes(s2), gap_open)
    mv = match_vector(moves, seq_bytes(s1), seq_bytes(s2))
    return block_aligned_stats(mv, k, match_id, len(s1), len(s2))


def cluster_reads(read_array, p_emp, cfg):
    """read_array: [(id, batch_i, acc, seq, qual, score)] in score order.
    Returns (clusters dict id->list[acc], set of representative ids)."""
    clusters = {i: [acc] for i, _, acc, _, _, _ in read_array}
    info = {}
    db = {}
    cluster_to_new = {}

    for (rid, b_i, acc, seq, qual, score) in read_array:
        hp = hpol_compress(seq)
        if len(hp) < cfg.k:
            continue
        minims = get_minimizers(hp, cfg.k, cfg.w)
        err = hpol_error_rate(seq, qual)
        info[rid] = (acc, seq, qual, err, hp)

        hits_n = defaultdict(int)
        hits_idx = defaultdict(list)
        hits_pos = defaultdict(list)
        for i, (m, pos) in enumerate(minims):
            if m in db:
                for cl in db[m]:
                    hits_n[cl] += 1
                    hits_idx[cl].append(i)
                    hits_pos[cl].append(pos)
        hits_n.pop(rid, None)
        hits_idx.pop(rid, None)
        hits_pos.pop(rid, None)

        best_m = -1
        nr_shared = 0
        if hits_n:
            tops = sorted(
                hits_pos.items(),
                key=lambda x: (len(x[1]), sum(x[1]), info[x[0]][0]),
                reverse=True,
            )
            top_hits = len(tops[0][1])
            nr_shared = top_hits
            if top_hits >= cfg.min_shared:
                for cl, positions in tops:
                    nm = len(positions)
                    if nm < cfg.min_fraction * top_hits or nm < cfg.min_shared:
                        break
                    idxs = hits_idx[cl]
                    p_err = 1.0 - p_shared(err, info[cl][3], p_emp)
                    probs = (
                        [reduce(mul, [p_err] * idxs[0], 1)]
                        + [reduce(mul, [p_err] * (i2 - i1 - 1), 1)
                           for i1, i2 in zip(idxs[:-1], idxs[1:])]
                        + [reduce(mul, [p_err] * (len(minims) - idxs[-1] - 1), 1)]
                    )
                    total = 0
                    for i in range(len(idxs)):
                        if probs[i] >= cfg.min_prob_no_hits:
                            total += positions[i] if i == 0 else positions[i] - positions[i - 1]
                    if probs[-1] >= cfg.min_prob_no_hits:
                        total += len(hp) - positions[-1]
                    ratio = total / float(len(hp))
                    rep_ratio = total / float(len(info[cl][4]))
                    if cfg.symmetric_map_align_thresholds:
                        if min(ratio, rep_ratio) > cfg.mapped_threshold:
                            best_m = cl
                            break
                    elif ratio > cfg.mapped_threshold:
                        best_m = cl
                        break

        best_a = -1
        if best_m < 0 and nr_shared >= cfg.min_shared:
            tops = sorted(
                hits_pos.items(),
                key=lambda x: (len(x[1]), sum(x[1]), info[x[0]][0]),
                reverse=True,
            )
            top_hits = len(tops[0][1])
            for cl, positions in tops:
                if len(positions) < top_hits:
                    break
                c_acc, c_seq, c_qual, c_err, c_hp = info[cl]
                ers = full_error_rate(seq, qual) + full_error_rate(c_seq, c_qual)
                if ers <= 0.01:
                    go = 5
                elif ers <= 0.04:
                    go = 4
                elif ers <= 0.1:
                    go = 3
                else:
                    go = 2
                match_id = math.floor((1.0 - ers) * cfg.k)
                r1, r2 = block_align(seq, c_seq, cfg.k, match_id, go)
                if cfg.symmetric_map_align_thresholds:
                    if min(r1, r2) >= cfg.aligned_threshold:
                        best_a = cl
                        break
                elif r1 >= cfg.aligned_threshold:
                    best_a = cl
                    break

        best = max(best_m, best_a)
        if best >= 0:
            cluster_to_new[rid] = best
        else:
            for m, pos in minims:
                db.setdefault(m, set()).add(rid)

    for rid, new_id in cluster_to_new.items():
        clusters[new_id].extend(clusters[rid])
        del clusters[rid]
    return clusters, set(clusters.keys())
