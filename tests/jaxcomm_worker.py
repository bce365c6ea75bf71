"""Multi-process ``JaxComm`` worker: the real jax.distributed transport.

DeviceWorld (tests/test_dist.py, __graft_entry__) proves the collective
*math* on a local mesh; this worker exercises the actual multi-host
*transport* — ``jax.distributed.initialize`` with a coordinator service,
gloo CPU collectives, and ``multihost_utils.process_allgather`` crossing
real OS process boundaries (the reference's process boundary is
``multiprocessing.Pool`` spawn, reference modules/parallelize.py:132,153).

Run one process per rank:

    python tests/jaxcomm_worker.py RANK NPROCS PORT OUT_JSON [SORTED_FASTQ]

Each rank runs the FULL distributed clustering driver with ``JaxComm`` on
a deterministic simulated pool and writes its replicated result as JSON;
the spawner (tests/test_dist.py::TestJaxCommMultiProcess or
__graft_entry__.dryrun_multichip) asserts every rank's output equals the
single-host merge tree.
"""

import json
import os
import sys


def make_read_array(seed: int = 0, n_templates: int = 3, reads_per: int = 12):
    """Deterministic simulated pool (same shape as the dryrun's)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    acgt = np.frombuffer(b"ACGT", dtype=np.uint8)
    read_array = []
    rid = 0
    for _ in range(n_templates):
        template = acgt[rng.integers(0, 4, size=300)]
        for _ in range(reads_per):
            keep = rng.random(template.size) > 0.06
            seq = template[keep].tobytes().decode()
            qual = "I" * len(seq)
            read_array.append((rid, 0, f"r{rid}_x", seq, qual,
                               float(len(seq) - rid * 1e-3)))
            rid += 1
    read_array.sort(key=lambda r: -r[5])
    return [(i, 0, r[2], r[3], r[4], r[5]) for i, r in enumerate(read_array)]


class _PayloadMeter:
    """JaxComm wrapper that accounts collective payload bytes (the codec
    must be measured at megabyte-class payloads)."""

    def __init__(self, comm):
        self._comm = comm
        self.rank = comm.rank
        self.size = comm.size
        self.sent_bytes = 0
        self.recv_bytes = 0
        self.max_payload_bytes = 0
        self.n_collectives = 0

    def allgather_i64(self, arr):
        self.sent_bytes += int(arr.size) * 8
        self.max_payload_bytes = max(self.max_payload_bytes,
                                     int(arr.size) * 8)
        out = self._comm.allgather_i64(arr)
        self.recv_bytes += sum(int(a.size) * 8 for a in out)
        self.n_collectives += 1
        return out

    def barrier(self, name):
        self._comm.barrier(name)

    def __getattr__(self, name):
        # any other method passes through unmetered: a method missing on
        # the wrapped comm then raises instead of leaving peers waiting
        return getattr(self._comm, name)


def run_driver(comm, nr_cores: int, sorted_fastq: str = ""):
    """Cluster the toy pool (default) or a real pre-sorted pool.

    ``sorted_fastq``: path to a stage-1 output (shared filesystem, the
    reference's own multi-worker assumption, parallelize.py:153); every
    rank loads the same score-sorted array and owns a subset of shards."""
    from ngspeciesid.cluster.engine import GapPassTable
    from ngspeciesid.cluster.store import build_store
    from ngspeciesid.config import Config
    from ngspeciesid.parallel.dist import distributed_clustering
    from ngspeciesid.parallel.merge import merge_tree_clustering
    from ngspeciesid.utils.ptable import load_p_table, p_table_as_matrix

    cfg = Config(nr_cores=nr_cores, outfolder=None)
    if sorted_fastq:
        from ngspeciesid.pipeline import load_read_array

        read_array = load_read_array(sorted_fastq, cfg)
    else:
        read_array = make_read_array()
    store = build_store(read_array, cfg.k, cfg.w)
    p_matrix = p_table_as_matrix(load_p_table(cfg.k, cfg.w))
    max_gap = max((c.size for c in store.min_codes), default=1)
    gap_table = GapPassTable(p_matrix, cfg.min_prob_no_hits, max_gap)
    if comm is None:
        import tempfile
        cfg.outfolder = tempfile.mkdtemp()
        return merge_tree_clustering(store, read_array, gap_table, cfg)
    return distributed_clustering(store, read_array, gap_table, cfg, comm,
                                  write_intermediate=False)


def main() -> int:
    rank, nprocs = int(sys.argv[1]), int(sys.argv[2])
    port, out_path = sys.argv[3], sys.argv[4]
    sorted_fastq = sys.argv[5] if len(sys.argv) > 5 else ""

    # Pin the backend (env var and config; CPU unless JAX_PLATFORMS names
    # another), select gloo so CPU collectives span processes, and join the
    # coordinator.  On GPUs each rank sees its own card.
    platform = os.environ.get("JAX_PLATFORMS") or "cpu"
    os.environ["JAX_PLATFORMS"] = platform
    if platform == "cpu":
        os.environ.setdefault("XLA_FLAGS",
                              "--xla_force_host_platform_device_count=1")
    import jax

    jax.config.update("jax_platforms", platform)
    jax.config.update("jax_enable_x64", True)
    if platform == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(
        coordinator_address=f"127.0.0.1:{port}",
        num_processes=nprocs, process_id=rank,
        initialization_timeout=120)
    assert jax.process_count() == nprocs, (
        f"rank {rank}: jax.distributed formed a {jax.process_count()}-process "
        f"world, wanted {nprocs}")

    from ngspeciesid.ops.align_stats import COUNTERS
    from ngspeciesid.parallel.dist import JaxComm

    import time

    comm = _PayloadMeter(JaxComm())
    assert comm.size == nprocs and comm.rank == rank
    t0 = time.time()
    clusters, alive = run_driver(comm, nr_cores=nprocs,
                                 sorted_fastq=sorted_fastq)
    wall = time.time() - t0
    comm.barrier("jaxcomm-worker-done")
    dev = jax.local_devices()[0]
    with open(out_path, "w") as f:
        json.dump({"rank": rank,
                   "device": {"platform": dev.platform,
                              "kind": dev.device_kind},
                   "device_pairs": COUNTERS["pairs"],
                   "clusters": {str(k): v for k, v in clusters.items()},
                   "alive": alive,
                   "wall_s": round(wall, 2),
                   "sent_bytes": comm.sent_bytes,
                   "recv_bytes": comm.recv_bytes,
                   "max_payload_bytes": comm.max_payload_bytes,
                   "n_collectives": comm.n_collectives}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
