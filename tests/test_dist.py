"""Distributed clustering driver: rank-sharded merge tree over collectives.

Differential contract: P ThreadComm ranks (the in-process stand-in for
jax.distributed hosts — same driver code, thread-barrier transport) must
produce exactly the clustering of the single-host merge tree at nr_cores=P,
and the result must be identically replicated on every rank.
"""

import os
import tempfile
import threading

import numpy as np
import pytest

from ngspeciesid.cluster.engine import GapPassTable
from ngspeciesid.cluster.store import build_store
from ngspeciesid.config import Config
from ngspeciesid.parallel.dist import (
    LocalComm,
    ThreadWorld,
    _decode_results,
    _encode_results,
    distributed_clustering,
)
from ngspeciesid.parallel.merge import merge_tree_clustering
from ngspeciesid.utils.ptable import load_p_table, p_table_as_matrix

from .test_cluster_engine import simulate_reads, to_read_array


def _gap_table(store, cfg):
    p_matrix = p_table_as_matrix(load_p_table(cfg.k, cfg.w))
    max_gap = max((c.size for c in store.min_codes), default=1)
    return GapPassTable(p_matrix, cfg.min_prob_no_hits, max_gap)


def _run_distributed(read_array, cfg_kwargs, n_ranks):
    """Run the driver on n_ranks threads, each with its own store (hosts do
    not share memory); returns the per-rank results."""
    world = ThreadWorld(n_ranks)
    results = [None] * n_ranks
    errors = []

    def worker(rank):
        try:
            cfg = Config(**cfg_kwargs)
            store = build_store(read_array, cfg.k, cfg.w)
            gap_table = _gap_table(store, cfg)
            results[rank] = distributed_clustering(
                store, read_array, gap_table, cfg, world.comm(rank),
                write_intermediate=False,
            )
        except BaseException as e:  # surface into the main thread
            errors.append(e)
            world._barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,)) for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


def _run_merge_tree(read_array, cfg_kwargs):
    cfg = Config(**cfg_kwargs)
    cfg.outfolder = tempfile.mkdtemp()
    store = build_store(read_array, cfg.k, cfg.w)
    gap_table = _gap_table(store, cfg)
    return merge_tree_clustering(store, read_array, gap_table, cfg)


class TestCodec:
    def test_roundtrip(self):
        results = {
            0: ({7: [7, 3, 9], 11: [11]}, [7, 11]),
            3: ({}, []),
            5: ({2: [2]}, [2]),
        }
        flat = _encode_results(results)
        assert flat.dtype == np.int64
        assert _decode_results(flat) == results

    def test_empty(self):
        assert _decode_results(_encode_results({})) == {}


class TestDistributedEqualsMergeTree:
    @pytest.mark.parametrize("n_ranks", [2, 4])
    def test_matches_single_host_merge_tree(self, rng, n_ranks):
        records = simulate_reads(rng, n_templates=3, reads_per=14, err=0.08)
        read_array = to_read_array(records)
        kwargs = dict(nr_cores=n_ranks, outfolder=None)
        want_clusters, want_alive = _run_merge_tree(read_array, kwargs)
        got = _run_distributed(read_array, kwargs, n_ranks)
        for clusters, alive in got:
            assert clusters == want_clusters
            assert alive == want_alive

    def test_replicated_across_ranks(self, rng):
        records = simulate_reads(rng, n_templates=2, reads_per=10, err=0.1)
        read_array = to_read_array(records)
        got = _run_distributed(read_array, dict(nr_cores=3, outfolder=None), 3)
        for r in got[1:]:
            assert r == got[0]

    def test_more_ranks_than_meaningful_shards(self, rng):
        # tiny input: batch_list may yield fewer shards than ranks; idle
        # ranks must still participate in the collectives and agree
        records = simulate_reads(rng, n_templates=1, reads_per=5)
        read_array = to_read_array(records)
        kwargs = dict(nr_cores=4, outfolder=None)
        want_clusters, want_alive = _run_merge_tree(read_array, kwargs)
        got = _run_distributed(read_array, kwargs, 4)
        for clusters, alive in got:
            assert clusters == want_clusters
            assert alive == want_alive

    def test_single_rank_localcomm(self, rng):
        # LocalComm degenerates to the merge tree without any exchange
        records = simulate_reads(rng, n_templates=2, reads_per=8)
        read_array = to_read_array(records)
        kwargs = dict(nr_cores=1, outfolder=None)
        cfg = Config(**kwargs)
        store = build_store(read_array, cfg.k, cfg.w)
        gap_table = _gap_table(store, cfg)
        got = distributed_clustering(
            store, read_array, gap_table, cfg, LocalComm(),
            write_intermediate=False)
        want = _run_merge_tree(read_array, kwargs)
        assert got == want


def _run_distributed_devices(read_array, cfg_kwargs, n_ranks):
    """Like _run_distributed but over DeviceWorld: the exchange is a real
    XLA all_gather across the n_ranks-device mesh (conftest forces 8
    virtual CPU devices), not a shared-memory slot swap."""
    from ngspeciesid.parallel.dist import DeviceWorld

    world = DeviceWorld(n_ranks)
    results = [None] * n_ranks
    errors = []

    def worker(rank):
        try:
            cfg = Config(**cfg_kwargs)
            store = build_store(read_array, cfg.k, cfg.w)
            gap_table = _gap_table(store, cfg)
            results[rank] = distributed_clustering(
                store, read_array, gap_table, cfg, world.comm(rank),
                write_intermediate=False,
            )
        except BaseException as e:
            errors.append(e)
            world._barrier.abort()

    threads = [threading.Thread(target=worker, args=(r,))
               for r in range(n_ranks)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return results


class TestDeviceCollectives:
    """The distributed driver over REAL XLA collectives:
    DeviceWorld rendezvouses the ranks and runs shard_map(lax.all_gather)
    over the device mesh for every exchange."""

    @pytest.mark.parametrize("n_ranks", [2, 4, 8])
    def test_device_collectives_match_merge_tree(self, rng, n_ranks):
        import jax
        if len(jax.devices()) < n_ranks:
            pytest.skip("needs %d devices" % n_ranks)
        records = simulate_reads(rng, n_templates=3, reads_per=12, err=0.08)
        read_array = to_read_array(records)
        kwargs = dict(nr_cores=n_ranks, outfolder=None)
        want_clusters, want_alive = _run_merge_tree(read_array, kwargs)
        got = _run_distributed_devices(read_array, kwargs, n_ranks)
        for clusters, alive in got:
            assert clusters == want_clusters
            assert alive == want_alive

    def test_matches_threadworld(self, rng):
        records = simulate_reads(rng, n_templates=2, reads_per=10, err=0.1)
        read_array = to_read_array(records)
        kwargs = dict(nr_cores=4, outfolder=None)
        via_threads = _run_distributed(read_array, kwargs, 4)
        via_devices = _run_distributed_devices(read_array, kwargs, 4)
        assert via_devices == via_threads


def spawn_jaxcomm_workers(n_ranks: int, out_dir, timeout_s: float = 300.0,
                          sorted_fastq: str = "", with_stats: bool = False,
                          platform: str = "cpu"):
    """Spawn ``n_ranks`` REAL OS processes running tests/jaxcomm_worker.py
    under ``jax.distributed.initialize``; returns the per-rank
    (clusters, alive) results.  ``platform`` "cpu" joins the ranks with
    gloo CPU collectives; "cuda" gives rank r the card r alone.  Shared by
    the pytest below and by chip_smoke.py --multi-gpu."""
    import json
    import os
    import socket
    import subprocess
    import sys

    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "jaxcomm_worker.py")
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    root = os.path.dirname(os.path.dirname(worker))
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = platform
    if platform == "cpu":
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=1"
    else:
        env.pop("XLA_FLAGS", None)
    # the worker runs as a script, so sys.path[0] is tests/: put the repo
    # root on its path to import the package
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    procs, outs = [], []
    for r in range(n_ranks):
        if platform != "cpu":
            env = dict(env, CUDA_VISIBLE_DEVICES=str(r))   # one card each
        out = os.path.join(str(out_dir), f"jaxcomm_rank{r}.json")
        outs.append(out)
        argv = [sys.executable, worker, str(r), str(n_ranks), str(port), out]
        if sorted_fastq:
            argv.append(sorted_fastq)
        procs.append(subprocess.Popen(
            argv, env=env, cwd=root,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        for r, p in enumerate(procs):
            rc = p.wait(timeout=timeout_s)
            if rc != 0:
                err = p.stderr.read().decode(errors="replace")[-2000:]
                raise RuntimeError(f"jaxcomm worker rank {r} exited {rc}:\n{err}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    results = []
    for out in outs:
        with open(out) as f:
            d = json.load(f)
        item = ({int(k): v for k, v in d["clusters"].items()}, d["alive"])
        if with_stats:
            item = item + ({k: d[k] for k in (
                "wall_s", "sent_bytes", "recv_bytes", "max_payload_bytes",
                "n_collectives", "device", "device_pairs")},)
        results.append(item)
    return results


class TestJaxCommMultiProcess:
    """JaxComm over the REAL multi-process transport:
    N OS processes join a jax.distributed coordinator, the exchange is
    multihost_utils.process_allgather over gloo, and every rank's full
    distributed-clustering result must equal the single-host merge tree."""

    def test_two_process_jaxcomm_matches_merge_tree(self, tmp_path):
        from .jaxcomm_worker import run_driver

        got = spawn_jaxcomm_workers(2, tmp_path)
        want_clusters, want_alive = run_driver(None, nr_cores=2)
        for clusters, alive in got:
            assert clusters == want_clusters
            assert alive == want_alive

    @pytest.mark.slow
    def test_two_process_jaxcomm_100k_pool(self, tmp_path):
        """The multi-process transport at BASELINE-config-5 scale (VERDICT
        r4 item 3): 2 OS processes cluster the real 100k bench pool over
        gloo collectives; every rank's result must equal the single-host
        merge tree, and the collective codec must carry megabyte-class
        payloads.  Timed; walls and payload sizes land in the test log."""
        pool = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), ".bench_data", "pool100k.fastq")
        if not os.path.isfile(pool):
            pytest.skip("100k bench pool not present (python bench.py "
                        "generates it)")
        from ngspeciesid.config import Config
        from ngspeciesid.preprocess import score_and_sort
        from .jaxcomm_worker import run_driver

        (tmp_path / "sorted").mkdir()
        cfg = Config(fastq=pool, outfolder=str(tmp_path / "sorted"),
                     nr_cores=2)
        sorted_path = score_and_sort(cfg)

        import time

        t0 = time.time()
        got = spawn_jaxcomm_workers(2, tmp_path, timeout_s=900.0,
                                    sorted_fastq=sorted_path,
                                    with_stats=True)
        spawn_wall = time.time() - t0
        want_clusters, want_alive = run_driver(
            None, nr_cores=2, sorted_fastq=sorted_path)
        total_reads = 0
        for clusters, alive, stats in got:
            assert clusters == want_clusters
            assert alive == want_alive
            total_reads = sum(len(v) for v in clusters.values())
            assert stats["sent_bytes"] + stats["recv_bytes"] > 1_000_000, (
                "expected megabyte-class collective traffic at 100k scale")
            print(f"rank stats: {stats}")
        assert total_reads >= 99_000
        print(f"2-process 100k distributed clustering wall: {spawn_wall:.1f}s "
              f"(incl. worker startup)")
