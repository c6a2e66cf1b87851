"""Multi-host data parallelism glue.

The reference has no distributed component (SURVEY.md §2.3); this module
is the scale-out story.  The design keeps the network between hosts off
the hot path entirely:

* every host loads the model tables itself (they are MBs — replicated,
  never sharded);
* each host feeds ITS OWN utterance batch (per-host data loading; no
  cross-host audio transfer);
* the global mesh is ('data',) over all devices of all hosts, so a
  global `pjit`/`shard_map` step runs with purely device-local compute
  — the only collectives in alignment are inside the optional
  sequence-parallel path, and those stay within one host's cards;
* results (paths/scores, a few KB per utterance) come back per host.

Usage (one process per host, standard JAX multi-process launch):

    from soundswallower_tpu.parallel.multihost import (
        initialize, global_data_mesh, host_batch_to_global)

    initialize(coordinator_address, num_processes, process_id)
    mesh = global_data_mesh()
    global_batch = host_batch_to_global(mesh, local_feats)  # [B_host,...]
    # ... run the jitted step over the mesh ...

Single-process runs degrade to the local data mesh.
"""

from __future__ import annotations

import numpy as np

import jax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None) -> None:
    """jax.distributed.initialize wrapper; no-op when single-process
    (already initialized or no coordinator given)."""
    if coordinator_address is None:
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id)


def global_data_mesh() -> Mesh:
    """('data',) mesh over ALL devices of all processes."""
    return Mesh(np.array(jax.devices()), ("data",))


def host_batch_to_global(mesh: Mesh, local_batch):
    """Assemble a globally-sharded [B_global, ...] array from each
    host's local [B_host, ...] batch without any cross-host transfer
    (jax.make_array_from_process_local_data keeps every shard on the
    devices of the host that produced it)."""
    def put(x):
        spec = P("data", *([None] * (x.ndim - 1)))
        return jax.make_array_from_process_local_data(
            NamedSharding(mesh, spec), np.asarray(x))
    return jax.tree_util.tree_map(put, local_batch)


def local_results(global_array) -> np.ndarray:
    """Rows of a ('data',)-sharded result that live on THIS host, in
    order (the inverse of host_batch_to_global for outputs)."""
    shards = [s for s in global_array.addressable_shards]
    shards.sort(key=lambda s: s.index[0].start or 0)
    return np.concatenate([np.asarray(s.data) for s in shards])
