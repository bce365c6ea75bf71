#!/usr/bin/env python3
"""On-card smoke test: the device stats DP and the main pipeline on a GPU.

    python3 chip_smoke.py               # one card
    python3 chip_smoke.py --multi-gpu   # four cards: distributed clustering

One card, in order:

1. the ``gpu``-marked tests (tests/test_align_stats.py), then the CLI on a
   20,000-read pool (``python -m ngspeciesid ... --consensus --racon``,
   which must exit 0), each in a child process that exits before this one
   touches the card;
2. kernel parity: the CUDA stats DP against the numpy oracle
   (sg_align_numpy -> match_vector -> block_aligned_stats /
   identity_from_moves) and the native engine, on 700 bp and 2 kb pairs
   (some with non-ACGT symbols), band 0 and 150, k in {13, 15, 20, 30};
   then one 4,096-pair launch at band 150 against the native engine.  The
   DP is integer, so results must be identical;
3. end to end: a simulated 100,000-read pool (200 species, 700 bp, 7%
   error, seed 0) through the CLI's parser and pipeline with
   ``--consensus --medaka``, twice on the default (device) backend and
   twice with NGSID_STATS_BACKEND=native, in the order device, native,
   native, device; final_clusters.tsv and every consensus.fasta must be
   byte-identical;
4. the GRU polisher (data/polisher_gru.npz) calling bases on the card and
   on the CPU; the calls must be identical.

``--multi-gpu`` runs only the four-card phase: four ranks, one process per
card, cluster a simulated pool under jax.distributed, each on its own
card's device DP; every rank's result must equal the single-host merge tree
(``--t 4``).

Exits nonzero if any phase fails or no GPU is found.  The last line of
standard output is one JSON object with the device JAX reports.
"""

import argparse
import filecmp
import glob
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
import traceback

ROOT = os.path.dirname(os.path.abspath(__file__))


def fail(msg: str, code: int = 1):
    print(f"chip_smoke: {msg}", file=sys.stderr, flush=True)
    sys.exit(code)


def card_line() -> str:
    """Print each card's name and power limit as nvidia-smi gives them;
    return the first, which tags the numbers printed later."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
    except (OSError, subprocess.TimeoutExpired) as e:
        fail(f"nvidia-smi failed ({e}): no GPU here", 2)
    lines = out.stdout.strip().splitlines()
    if out.returncode != 0 or not lines:
        fail("nvidia-smi reports no GPU", 2)
    for line in lines:
        print(line, flush=True)
    return lines[0].strip()


def simulate(out: str, n_reads: int, n_species: int) -> None:
    subprocess.run(
        [sys.executable, os.path.join("scripts", "simulate_reads.py"),
         "--out", out, "--n_reads", str(n_reads), "--n_species",
         str(n_species), "--length", "700", "--error", "0.07", "--seed", "0"],
        cwd=ROOT, check=True, capture_output=True, timeout=600)


# ---------------------------------------------------------------------------
# one card
# ---------------------------------------------------------------------------

def phase_gpu_tests(card):
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    res = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "gpu",
         "-p", "no:cacheprovider", "tests/test_align_stats.py"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    last = res.stdout.strip().splitlines()[-1] if res.stdout.strip() else ""
    if res.returncode != 0 or "passed" not in last or "skipped" in last:
        raise RuntimeError(f"gpu tests: rc {res.returncode}\n"
                           f"{res.stdout[-3000:]}\n{res.stderr[-2000:]}")
    print(f"gpu tests: {last}")


def phase_cli(card, work):
    """The console entry point as its own process: it must use the card and
    exit 0 after a --consensus run (reference .travis.yml:33-36)."""
    pool = os.path.join(work, "pool20k.fastq")
    simulate(pool, 20_000, 50)
    out = os.path.join(work, "cli")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    res = subprocess.run(
        [sys.executable, "-m", "ngspeciesid", "--ont", "--fastq", pool,
         "--outfolder", out, "--consensus", "--racon",
         "--abundance_ratio", "0.01"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900)
    if res.returncode != 0:
        raise RuntimeError(f"CLI exited {res.returncode}:\n{res.stderr[-3000:]}")
    if not os.path.isfile(os.path.join(out, "final_clusters.tsv")):
        raise RuntimeError("CLI wrote no final_clusters.tsv")
    print(f"CLI process: exit 0, "
          f"{len(glob.glob(os.path.join(out, 'racon_cl_id_*')))} centers")


def _pairs(rng, length, n, err=0.07, n_templates=None):
    import numpy as np
    from scripts.simulate_reads import noisy_arrays

    acgt = np.frombuffer(b"ACGT", np.uint8)
    n_templates = n_templates or n
    temps = [acgt[rng.integers(0, 4, length)] for _ in range(n_templates)]
    reps = [noisy_arrays(rng, t, err)[0] for t in temps]
    seqs = list(reps)
    r1, r2 = [], []
    for _ in range(n):
        ti = int(rng.integers(0, n_templates))
        seqs.append(noisy_arrays(rng, temps[ti], err)[0])
        r1.append(len(seqs) - 1)
        r2.append(ti)
    return seqs, r1, r2


def phase_parity(card):
    import math

    import numpy as np

    from ngspeciesid import native
    from ngspeciesid.ops.align import (block_aligned_stats,
                                       identity_from_moves, match_vector,
                                       sg_align_numpy)
    from ngspeciesid.ops.align_stats import (sg_stats_batch_device,
                                             sg_stats_pool_device)

    rng = np.random.default_rng(0)
    checked = 0
    for length, n in ((700, 3), (2000, 2)):
        seqs, r1, r2 = _pairs(rng, length, n)
        pairs = [(seqs[a].copy(), seqs[b].copy()) for a, b in zip(r1, r2)]
        # non-ACGT symbols: an N run on both sides, IUPAC codes on one
        pairs[0][0][10:16] = ord("N")
        pairs[0][1][10:14] = ord("N")
        pairs[1][0][100:103] = np.frombuffer(b"RYK", np.uint8)
        opens = [3, 2, 4, 5][:n]
        moves = [sg_align_numpy(a, b, o) for (a, b), o in zip(pairs, opens)]
        for k in (13, 15, 20, 30):
            mids = [math.floor((1.0 - e) * k) for e in (0.14, 0.2, 0.1)][:n]
            want = []
            for (a, b), mv, mid in zip(pairs, moves, mids):
                v = match_vector(mv, a, b)
                want.append(block_aligned_stats(v, k, mid, a.size, b.size)
                            + (identity_from_moves(mv, a, b),))
            for band in (0, 150):
                got = sg_stats_batch_device(pairs, opens, [k] * n, mids,
                                            band=band)
                nat = native.block_stats_native(pairs, opens, [k] * n, mids,
                                                band=band)
                nat_id = native.identity_native(pairs, opens, band=band)
                for g, w, r, i in zip(got, want, nat, nat_id):
                    if tuple(g) != tuple(w) or tuple(g[:2]) != tuple(r) \
                            or g[2] != i:
                        raise RuntimeError(
                            f"parity {length} bp k={k} band={band}: "
                            f"device {g} oracle {w} native {r + (i,)}")
                    checked += 1
    print(f"parity vs numpy oracle and native: {checked} cases identical "
          "(700 bp and 2 kb, band 0/150, k 13/15/20/30, non-ACGT)")

    # one launch at the production width: 4,096 pairs, 700 bp, band 150
    seqs, r1, r2 = _pairs(rng, 700, 4096, n_templates=64)
    opens, ks, mids = [3] * 4096, [13] * 4096, [11] * 4096
    dev = sg_stats_pool_device(seqs, r1, r2, opens, ks, mids, band=150)
    times = []
    for _ in range(3):
        t = time.perf_counter()
        sg_stats_pool_device(seqs, r1, r2, opens, ks, mids, band=150)
        times.append(time.perf_counter() - t)
    pairs = [(seqs[a], seqs[b]) for a, b in zip(r1, r2)]
    t = time.perf_counter()
    nat = native.block_stats_native(pairs, opens, ks, mids, band=150)
    nat_s = time.perf_counter() - t
    bad = sum(tuple(g[:2]) != tuple(w) for g, w in zip(dev, nat))
    if bad:
        raise RuntimeError(f"4096-pair launch: {bad} pairs differ from native")
    print(f"4096 pairs x 700 bp, band 150: identical to native; device call "
          f"{min(times):.4f} s, native {nat_s:.4f} s on {os.cpu_count()} "
          f"cores [{card}]")


def phase_end_to_end(card, work):
    from ngspeciesid import cli, pipeline
    from ngspeciesid.cluster import engine
    from ngspeciesid.ops import align_stats
    from ngspeciesid.ops.align import stats_backend_default

    pool = os.path.join(work, "pool100k.fastq")
    t = time.time()
    simulate(pool, 100_000, 200)
    print(f"simulated 100k-read pool in {time.time() - t:.1f} s")
    outs = []
    # alternate the order, so neither backend always runs first
    for run, backend in enumerate(("device", "native", "native", "device")):
        if backend == "native":
            os.environ["NGSID_STATS_BACKEND"] = "native"
        else:
            os.environ.pop("NGSID_STATS_BACKEND", None)
            if stats_backend_default() != "device":
                raise RuntimeError("the default backend on a GPU host is "
                                   f"{stats_backend_default()!r}, not device")
        out = os.path.join(work, f"{backend}{run}")
        args = cli.build_parser().parse_args(
            ["--ont", "--fastq", pool, "--outfolder", out, "--consensus",
             "--medaka", "--abundance_ratio", "0.001"])
        cfg = cli.args_to_config(args)
        engine.reset_perf_counters()
        align_stats.COUNTERS.update(pairs=0, launches=0)
        walls = {}
        t = time.time()
        pipeline.run(cfg, walls)
        wall = time.time() - t
        counters = {k: round(v, 3) for k, v in engine.PERF_COUNTERS.items()}
        print(f"e2e {backend}: wall {wall:.2f} s, stage walls "
              f"{ {k: round(v, 2) for k, v in walls.items()} }, "
              f"PERF_COUNTERS {counters}, device DP pairs "
              f"{align_stats.COUNTERS['pairs']} in "
              f"{align_stats.COUNTERS['launches']} launches [{card}]")
        if backend == "device" and align_stats.COUNTERS["pairs"] <= 0:
            raise RuntimeError("the device DP aligned no pairs")
        outs.append(out)
    os.environ.pop("NGSID_STATS_BACKEND", None)

    def files(root):
        rel = [os.path.relpath(p, root) for p in glob.glob(
            os.path.join(root, "**", "consensus.fasta"), recursive=True)]
        return sorted(rel) + ["final_clusters.tsv"]

    want = files(outs[0])
    for out in outs[1:]:
        if files(out) != want:
            raise RuntimeError("device and native runs wrote different files")
        for rel in want:
            if not filecmp.cmp(os.path.join(outs[0], rel),
                               os.path.join(out, rel), shallow=False):
                raise RuntimeError(f"{rel} differs between "
                                   f"{os.path.basename(outs[0])} and "
                                   f"{os.path.basename(out)}")
    print(f"e2e: final_clusters.tsv and {len(want) - 1} consensus.fasta "
          "byte-identical across the device and native runs")


def phase_gru(card):
    import jax
    import numpy as np

    from ngspeciesid.models.polisher import neural_polish_round
    from ngspeciesid.models.train import load_params
    from scripts.simulate_reads import noisy_arrays

    params = jax.tree.map(np.asarray, load_params(
        os.path.join(ROOT, "ngspeciesid", "data", "polisher_gru.npz")))
    rng = np.random.default_rng(1)
    acgt = np.frombuffer(b"ACGT", np.uint8)
    cases = []
    for _ in range(8):
        template = acgt[rng.integers(0, 4, 700)]
        draft = noisy_arrays(rng, template, 0.03)[0]
        reads = [noisy_arrays(rng, template, 0.07) for _ in range(30)]
        cases.append((draft, [r for r, _ in reads], [q for _, q in reads]))
    calls = {}
    for dev in (jax.devices()[0], jax.devices("cpu")[0]):
        with jax.default_device(dev):
            p = jax.device_put(params, dev)
            calls[dev.platform] = [
                neural_polish_round(p, c, r, q).tobytes()
                for c, r, q in cases]
    if calls["gpu"] != calls["cpu"]:
        raise RuntimeError("GRU calls differ between the card and the CPU")
    print(f"GRU polisher: {len(cases)} centers called identically on the "
          f"card and the CPU [{card}]")


def single(card: str) -> dict:
    failures = []

    def run(name, fn, *args):
        t = time.time()
        try:
            fn(card, *args)
            print(f"phase {name}: ok ({time.time() - t:.1f} s)", flush=True)
        except Exception:
            failures.append(name)
            print(f"phase {name}: FAILED", flush=True)
            traceback.print_exc()

    # child processes first: this process does not hold the card yet
    run("gpu_tests", phase_gpu_tests)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run("cli", phase_cli, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    import jax

    if jax.default_backend() != "gpu":
        fail(f"JAX finds no GPU (backend {jax.default_backend()!r})", 2)
    run("parity", phase_parity)
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        run("end_to_end", phase_end_to_end, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    run("gru", phase_gru)
    if failures:
        fail(f"failed phases: {failures}")
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


# ---------------------------------------------------------------------------
# four cards
# ---------------------------------------------------------------------------

#: reads in the four-card phase's pool: each rank then runs thousands of
#: device DP pairs
MULTI_READS = 40_000


def multi(card: str) -> dict:
    os.environ["JAX_PLATFORMS"] = "cpu"    # this process stays off the cards
    from ngspeciesid.config import Config
    from ngspeciesid.preprocess import score_and_sort
    from tests.jaxcomm_worker import run_driver
    from tests.test_dist import spawn_jaxcomm_workers

    work = tempfile.mkdtemp(prefix="chip_smoke_multi_")
    try:
        pool = os.path.join(work, "pool.fastq")
        simulate(pool, MULTI_READS, MULTI_READS // 500)
        os.makedirs(os.path.join(work, "sorted"))
        sorted_path = score_and_sort(Config(
            fastq=pool, outfolder=os.path.join(work, "sorted"), nr_cores=4))
        t = time.time()
        got = spawn_jaxcomm_workers(4, work, timeout_s=900.0,
                                    sorted_fastq=sorted_path,
                                    with_stats=True, platform="cuda")
        print(f"4 ranks clustered {MULTI_READS} reads in {time.time() - t:.1f} s "
              "(incl. start-up)")
        want_clusters, want_alive = run_driver(None, nr_cores=4,
                                               sorted_fastq=sorted_path)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    for r, (clusters, alive, st) in enumerate(got):
        print(f"rank {r}: {st['device']}, device DP pairs "
              f"{st['device_pairs']}, wall {st['wall_s']} s, "
              f"{st['n_collectives']} collectives [{card}]")
        if clusters != want_clusters or alive != want_alive:
            fail(f"rank {r} differs from the merge tree (--t 4)")
        if st["device"]["platform"] != "gpu" or st["device_pairs"] <= 0:
            fail(f"rank {r} did not run its device DP on a card")
    print(f"every rank equals the single-host merge tree: "
          f"{len(want_clusters)} clusters")
    return {"platform": "gpu", "kind": got[0][2]["device"]["kind"],
            "count": len(got)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi-gpu", action="store_true",
                    help="run only the four-card distributed phase")
    args = ap.parse_args()
    if not os.path.isdir(os.path.join(ROOT, "ngspeciesid")):
        fail("the ngspeciesid package is not beside this script", 2)
    sys.path.insert(0, ROOT)
    card = card_line()
    device = multi(card) if args.multi_gpu else single(card)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
