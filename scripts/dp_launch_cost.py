#!/usr/bin/env python3
"""Launch cost of the device stats DP against the native engine, on a GPU.

    python3 scripts/dp_launch_cost.py           # lane split and batch ladder
    python3 scripts/dp_launch_cost.py --waves   # also the wave-size sweep

Measures what the dispatch constants rest on:

* lanes per thread (``ops/stats_cuda.TARGET_THREADS``): one 4,096-pair
  launch of 700 bp pairs at band 150, inputs resident, at 1, 2 and 4 lanes
  per thread, in the order 1, 2, 4, 2, 1;
* the batch ladder (``ops/align.DEVICE_MIN_BATCH``, ``align_stats.MAX_B``):
  the whole device call against the native engine for 1 to 4,096 pairs,
  the two alternating which runs first;
* with ``--waves``, the cluster wall of a simulated 100,000-read pool at
  several wave sizes on both backends (``cluster/engine.DEFAULT_WAVE_SIZE``).

Every time is the median of five runs after one warm-up.  The first line is
the card's name and power limit.
"""

import argparse
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

import jax  # noqa: E402


def median_time(fn, runs=5):
    fn()
    times = []
    for _ in range(runs):
        t = time.perf_counter()
        fn()
        times.append(time.perf_counter() - t)
    return sorted(times)[runs // 2]


def lane_split(seqs, r1, r2, opens, ks, mids):
    from ngspeciesid.ops import align_stats as A
    from ngspeciesid.ops.stats_cuda import stats_rows

    shape = A._chunk_shape(seqs, r1, r2, 150)
    for lanes in (1, 2, 4, 2, 1):
        def rows_fn(*a, **kw):
            return stats_rows(*a, lanes=lanes, **kw)

        def launch():
            rows = A._launch_chunk(seqs, r1, r2, opens, ks, mids, 2, -2, 1,
                                   150, rows_fn, shape)[0]
            jax.block_until_ready(rows)

        print(f"lanes {lanes}: 4096-pair launch {median_time(launch):.6f} s "
              f"(W {shape[5]})", flush=True)


def ladder(seqs, r1, r2, opens, ks, mids):
    from ngspeciesid import native
    from ngspeciesid.ops.align_stats import sg_stats_pool_device

    for step, B in enumerate((1, 64, 128, 256, 512, 1024, 2048, 4096)):
        s1, s2 = r1[:B], r2[:B]
        pairs = [(seqs[a], seqs[b]) for a, b in zip(s1, s2)]
        runs = {
            "device": lambda: sg_stats_pool_device(
                seqs, s1, s2, opens[:B], ks[:B], mids[:B], band=150),
            "native": lambda: native.block_stats_native(
                pairs, opens[:B], ks[:B], mids[:B], band=150),
        }
        order = ("device", "native") if step % 2 == 0 else ("native", "device")
        got = {name: median_time(runs[name]) for name in order}
        print(f"ladder {B} pairs: device {got['device']:.6f} s, native "
              f"{got['native']:.6f} s ({order[0]} first)", flush=True)


def waves():
    import chip_smoke
    from ngspeciesid import cli, pipeline
    from ngspeciesid.cluster import engine
    from ngspeciesid.ops import align_stats as A

    work = tempfile.mkdtemp(prefix="dp_launch_cost_")
    try:
        pool = os.path.join(work, "pool.fastq")
        chip_smoke.simulate(pool, 100_000, 200)
        for backend, wave in (("device", 256), ("native", 256),
                              ("native", 1024), ("device", 1024),
                              ("device", 4096), ("device", 256),
                              ("native", 256)):
            os.environ["NGSID_STATS_BACKEND"] = backend
            out = os.path.join(work, f"{backend}{wave}")
            cfg = cli.args_to_config(cli.build_parser().parse_args(
                ["--ont", "--fastq", pool, "--outfolder", out,
                 "--wave_size", str(wave)]))
            engine.reset_perf_counters()
            A.COUNTERS.update(pairs=0, launches=0)
            walls = {}
            pipeline.run(cfg, walls)
            counters = {k: round(v, 3) for k, v in
                        engine.PERF_COUNTERS.items()}
            print(f"wave {wave} {backend}: cluster {walls['cluster']:.3f} s, "
                  f"{counters}, device pairs {A.COUNTERS['pairs']}",
                  flush=True)
            shutil.rmtree(out)
    finally:
        os.environ.pop("NGSID_STATS_BACKEND", None)
        shutil.rmtree(work, ignore_errors=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--waves", action="store_true",
                    help="also sweep the wave size on a 100k-read pool")
    args = ap.parse_args()
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip(), flush=True)
    if jax.default_backend() != "gpu":
        print("no GPU: nothing to measure", file=sys.stderr)
        return 2
    from chip_smoke import _pairs

    rng = np.random.default_rng(0)
    seqs, r1, r2 = _pairs(rng, 700, 4096, n_templates=64)
    opens, ks, mids = [3] * 4096, [13] * 4096, [11] * 4096
    lane_split(seqs, r1, r2, opens, ks, mids)
    ladder(seqs, r1, r2, opens, ks, mids)
    if args.waves:
        waves()
    return 0


if __name__ == "__main__":
    sys.exit(main())
