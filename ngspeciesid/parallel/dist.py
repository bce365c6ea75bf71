"""Multi-host distributed clustering over jax.distributed collectives.

The reference's parallel clustering is single-host multiprocessing with
pickled dict merges (reference modules/parallelize.py:107-217).  This module
runs the same hierarchical merge-tree topology across *hosts*: every host
reads the shared sorted fastq, takes ownership of a subset of shards, runs
the wave-batched engine on them, and exchanges per-round results through
all-gather collectives (NCCL between GPUs, gloo between CPU processes)
instead of pipes.

Design properties that make the exchange cheap and the result replicated:

  * Every host holds the full score-sorted read array (shared filesystem —
    the reference makes the same assumption for its worker processes), so
    the collective payload is only int64 ids: surviving representative ids
    plus (rep id, member ids) cluster postings.  Sequences never move.
  * A shard's minimizer database is exactly the minimizers of its surviving
    representatives (the engine only inserts codes when a read *becomes* a
    representative, reference cluster.py:329-334, and never deletes), so a
    new owner rebuilds the carried DB locally from survivor ids instead of
    shipping postings.
  * The merge bookkeeping (survivor re-sort, consecutive shard pairing,
    carried-DB selection — reference parallelize.py:184-215) is
    deterministic, so every rank replays it identically and the final
    clustering is replicated on all ranks without a broadcast; the last
    single-shard pass (reference parallelize.py:142-149) runs replicated.

Determinism across placements: decisions depend only on the frozen DB
snapshot and the total-order candidate key (hits, sum positions, accession
rank — reference cluster.py:79), never on posting order, so rebuild order
is free and the distributed result equals the single-host merge tree
(differential-tested in tests/test_dist.py).
"""

from __future__ import annotations

import logging
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..config import Config
from ..cluster.engine import GapPassTable, MinimizerDB, reads_to_clusters
from ..cluster.store import ReadStore
from .merge import batch_list, _print_intermediate

logger = logging.getLogger(__name__)

ReadTuple = Tuple[int, int, str, str, str, float]


# ---------------------------------------------------------------------------
# communication backends
# ---------------------------------------------------------------------------

class JaxComm:
    """Collective exchange over the jax.distributed runtime (multi-host).

    Variable-length int64 all-gather as two fixed-shape collectives:
    gather sizes, pad to the max, gather data.  Rides NCCL between GPUs and
    gloo between CPU processes; callers never touch device placement.
    """

    def __init__(self) -> None:
        import jax

        self.rank = jax.process_index()
        self.size = jax.process_count()

    def allgather_i64(self, arr: np.ndarray) -> List[np.ndarray]:
        import jax.numpy as jnp
        from jax.experimental import multihost_utils

        arr = np.ascontiguousarray(arr, dtype=np.int64)
        sizes = np.asarray(
            multihost_utils.process_allgather(jnp.asarray([arr.size], jnp.int64))
        ).reshape(self.size)
        mx = max(1, int(sizes.max()))
        pad = np.zeros(mx, dtype=np.int64)
        pad[: arr.size] = arr
        data = np.asarray(
            multihost_utils.process_allgather(jnp.asarray(pad))
        ).reshape(self.size, mx)
        return [data[p, : int(sizes[p])].copy() for p in range(self.size)]

    def barrier(self, name: str) -> None:
        from jax.experimental import multihost_utils

        multihost_utils.sync_global_devices(name)


class DeviceWorld:
    """P-rank world whose exchange IS an XLA all-gather over a P-device
    mesh (one rank per device).  Ranks run as threads (each standing for a
    host's driver); at every exchange they rendezvous, each payload lands
    on its rank's device, and a single ``shard_map(lax.all_gather)``
    computation over ``Mesh((P,), 'rank')`` moves the data — the same
    collective JaxComm issues across hosts via process_allgather, executed
    here across the local mesh (the 8-virtual-CPU-device mesh in tests and
    the multi-device dry run; NVLink between the cards of a GPU host).  Unlike ThreadWorld, no rank
    ever reads another rank's buffer from shared memory: all data moves
    through the XLA collective."""

    def __init__(self, size: int) -> None:
        import jax
        from functools import partial
        from jax.sharding import Mesh, PartitionSpec

        devs = jax.devices()
        if len(devs) < size:
            raise ValueError(f"DeviceWorld({size}) needs {size} devices, "
                             f"have {len(devs)}")
        self.devices = devs[:size]
        self.size = size
        self._barrier = threading.Barrier(size)
        self._in: List[Optional[np.ndarray]] = [None] * size
        self._out: Optional[List[np.ndarray]] = None
        self._mesh = Mesh(np.asarray(self.devices), ("rank",))

        # the jitted collective is built ONCE per world: a closure created
        # inside _exchange would be a fresh function every call and retrace
        # each exchange (ADVICE r3); jit's own cache handles new payload
        # shapes, identical shapes reuse the compiled executable
        @jax.jit
        @partial(jax.shard_map, mesh=self._mesh,
                 in_specs=PartitionSpec("rank", None),
                 out_specs=PartitionSpec(None, None),
                 check_vma=False)  # all_gather output is replicated by
        def _ag(x):                # construction; the static checker
            return jax.lax.all_gather(x, "rank", axis=0, tiled=True)

        self._ag = _ag

    def comm(self, rank: int) -> "DeviceComm":
        return DeviceComm(self, rank)

    def _exchange(self) -> None:
        import jax
        from jax.sharding import NamedSharding, PartitionSpec

        sizes = np.array([a.size for a in self._in], np.int64)
        mx = max(1, int(sizes.max()))
        blocks = [
            jax.device_put(np.pad(a, (0, mx - a.size))[None, :], d)
            for a, d in zip(self._in, self.devices)
        ]
        garr = jax.make_array_from_single_device_arrays(
            (self.size, mx),
            NamedSharding(self._mesh, PartitionSpec("rank", None)), blocks)
        data = np.asarray(self._ag(garr))
        self._out = [data[p, : int(sizes[p])].copy()
                     for p in range(self.size)]


class DeviceComm:
    def __init__(self, world: DeviceWorld, rank: int) -> None:
        self._world = world
        self.rank = rank
        self.size = world.size

    def allgather_i64(self, arr: np.ndarray) -> List[np.ndarray]:
        w = self._world
        w._in[self.rank] = np.ascontiguousarray(arr, dtype=np.int64)
        w._barrier.wait()
        if self.rank == 0:
            w._exchange()
        w._barrier.wait()
        out = [a.copy() for a in w._out]  # type: ignore[union-attr]
        w._barrier.wait()                 # all read before the next round
        return out

    def barrier(self, name: str) -> None:
        self._world._barrier.wait()


class ThreadWorld:
    """In-process P-rank world for tests: one thread per rank, barrier-
    synchronised slot exchange.  Exercises the exact driver code path the
    multi-host deployment runs; only the transport differs."""

    def __init__(self, size: int) -> None:
        self.size = size
        self._barrier = threading.Barrier(size)
        self._slots: List[Optional[np.ndarray]] = [None] * size

    def comm(self, rank: int) -> "ThreadComm":
        return ThreadComm(self, rank)


class ThreadComm:
    def __init__(self, world: ThreadWorld, rank: int) -> None:
        self._world = world
        self.rank = rank
        self.size = world.size

    def allgather_i64(self, arr: np.ndarray) -> List[np.ndarray]:
        w = self._world
        w._slots[self.rank] = np.ascontiguousarray(arr, dtype=np.int64)
        w._barrier.wait()
        out = [w._slots[p].copy() for p in range(w.size)]
        w._barrier.wait()  # all ranks read before the next round overwrites
        return out

    def barrier(self, name: str) -> None:
        self._world._barrier.wait()


class LocalComm:
    """Single-rank comm: the distributed driver degenerates to the
    single-host merge tree."""

    rank = 0
    size = 1

    def allgather_i64(self, arr: np.ndarray) -> List[np.ndarray]:
        return [np.ascontiguousarray(arr, dtype=np.int64)]

    def barrier(self, name: str) -> None:
        pass


# ---------------------------------------------------------------------------
# payload codec: per-round shard results as one flat int64 array
# ---------------------------------------------------------------------------

def _encode_results(
    results: Dict[int, Tuple[Dict[int, List[int]], List[int]]]
) -> np.ndarray:
    out: List[int] = [len(results)]
    for si in sorted(results):
        clusters, alive = results[si]
        out.append(si)
        out.append(len(alive))
        out.extend(alive)
        out.append(len(clusters))
        for rid, members in clusters.items():
            out.append(rid)
            out.append(len(members))
            out.extend(members)
    return np.asarray(out, dtype=np.int64)


def _decode_results(
    flat: np.ndarray,
) -> Dict[int, Tuple[Dict[int, List[int]], List[int]]]:
    flat = flat.tolist()
    pos = 0

    def take(n: int) -> List[int]:
        nonlocal pos
        out = flat[pos : pos + n]
        pos += n
        return out

    results: Dict[int, Tuple[Dict[int, List[int]], List[int]]] = {}
    (n_shards,) = take(1)
    for _ in range(n_shards):
        si, n_alive = take(2)
        alive = take(n_alive)
        (n_clusters,) = take(1)
        clusters: Dict[int, List[int]] = {}
        for _ in range(n_clusters):
            rid, n_members = take(2)
            clusters[rid] = take(n_members)
        results[si] = (clusters, alive)
    return results


# ---------------------------------------------------------------------------
# driver
# ---------------------------------------------------------------------------

def _rebuild_db(store: ReadStore, alive_ids: Sequence[int], k: int) -> MinimizerDB:
    """Carried DB of a shard == minimizers of its surviving representatives
    (insertion-only invariant of the engine; see module docstring)."""
    db = MinimizerDB()
    for rid in alive_ids:
        row = store.id_to_row[int(rid)]
        if store.hpol[row].size >= k:
            db.insert(store.min_codes[row], int(rid))
    return db


def _run_shard(
    store: ReadStore,
    batch: Sequence[ReadTuple],
    all_clusters: Dict[int, List[int]],
    carried_alive: Sequence[int],
    gap_table: GapPassTable,
    cfg: Config,
    new_batch_index: int,
) -> Tuple[Dict[int, List[int]], List[int]]:
    rows = np.array([store.row(r[0]) for r in batch], dtype=np.int64)
    skip_idx = max(1, min((r[1] for r in batch), default=1))
    clusters = {r[0]: all_clusters[r[0]] for r in batch}
    clusters, alive, _ = reads_to_clusters(
        store, clusters, rows, gap_table, cfg,
        carried_db=_rebuild_db(store, carried_alive, cfg.k),
        skip_batch_index=skip_idx,
        new_batch_index=new_batch_index,
    )
    return clusters, alive


def distributed_clustering(
    store: ReadStore,
    read_array: Sequence[ReadTuple],
    gap_table: GapPassTable,
    cfg: Config,
    comm,
    write_intermediate: bool = True,
) -> Tuple[Dict[int, List[str]], List[int]]:
    """Merge-tree clustering with shards owned by ranks; returns the
    replicated (clusters, surviving rep ids) on every rank.  Cluster values
    are accession lists, as in parallel/merge.py."""
    P = comm.size
    # round 1 keeps empty shards so batch-index numbering matches the
    # single-host merge tree exactly (merge rounds filter them, as it does)
    shards = list(batch_list(read_array, P, batch_type=cfg.batch_type))
    # members tracked as read ids; converted to accessions at the end
    all_clusters: Dict[int, List[int]] = {r[0]: [r[0]] for r in read_array}
    # carried-DB source: batch index -> surviving rep ids of that shard
    alive_by_batch: Dict[int, List[int]] = {}
    it = 1
    while True:
        logger.debug("DIST ITERATION %d with %d shards on %d ranks",
                     it, len(shards), P)
        if len(shards) == 1:
            # final pass runs replicated on every rank (deterministic), like
            # the reference's in-process finish (parallelize.py:142-149)
            batch = shards[0]
            lowest = min((r[1] for r in batch), default=0)
            clusters, alive = _run_shard(
                store, batch, all_clusters,
                alive_by_batch.get(lowest, []), gap_table, cfg,
                new_batch_index=1,
            )
            final = {
                rid: [store.accs[store.row(m)] for m in members]
                for rid, members in clusters.items()
            }
            return final, alive

        # --- owned shards run locally
        owned: Dict[int, Tuple[Dict[int, List[int]], List[int]]] = {}
        for si, batch in enumerate(shards):
            if si % P != comm.rank:
                continue
            lowest = min((r[1] for r in batch), default=0) if it > 1 else -1
            owned[si] = _run_shard(
                store, batch, all_clusters,
                alive_by_batch.get(lowest, []), gap_table, cfg,
                new_batch_index=si + 1,
            )

        # --- exchange: every rank learns every shard's result
        gathered = comm.allgather_i64(_encode_results(owned))
        results: Dict[int, Tuple[Dict[int, List[int]], List[int]]] = {}
        for payload in gathered:
            results.update(_decode_results(payload))

        # --- replicated merge bookkeeping (reference parallelize.py:168-215)
        for si in range(len(shards)):
            clusters, _ = results[si]
            all_clusters.update(clusters)
            # every read of the pass carries the shard's batch index now
            rows = np.array([store.row(r[0]) for r in shards[si]], dtype=np.int64)
            store.batch_indices[rows] = si + 1
        surviving: List[int] = []
        for si in range(len(shards)):
            surviving.extend(results[si][1])
        surviving.sort(key=lambda rid: -store.scores[store.row(rid)])
        read_array = [
            (rid, int(store.batch_indices[store.row(rid)]),
             store.accs[store.row(rid)], store.seq_b[store.row(rid)],
             store.qual_b[store.row(rid)], float(store.scores[store.row(rid)]))
            for rid in surviving
        ]
        pruned = {rid: all_clusters[rid] for rid in surviving}
        all_clusters = pruned
        alive_by_batch = {si + 1: results[si][1] for si in range(len(shards))}

        if write_intermediate and comm.rank == 0 and cfg.outfolder:
            acc_view = {
                rid: [store.accs[store.row(m)] for m in members]
                for rid, members in pruned.items()
            }
            _print_intermediate(acc_view, store, cfg, it)
        comm.barrier(f"dist-clustering-it{it}")

        it += 1
        shards = [
            b for b in batch_list(read_array, merge_consecutive=True) if b
        ]
