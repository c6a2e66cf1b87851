"""Device mesh + sharding helpers for batched decoding/alignment.

The reference is strictly single-threaded (SURVEY.md section 2.3); all
parallelism here is new design:

* data axis: utterance batches sharded across devices; every
  utterance's state (CMN, Viterbi scores, token stacks) lives with its
  shard, and the pipeline needs no collectives
* model tables (means/variances/mixw, a few MB) are replicated
* meshes take ``jax.devices()`` in order: the cards of one host are
  joined all to all (NVLink), so no device order is better than another
* the only collectives are the sequence-parallel ring of
  parallel/seqpipe.py
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def data_mesh(n_devices: int | None = None) -> Mesh:
    devs = jax.devices()
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(np.array(devs), ("data",))


def shard_batch(mesh: Mesh, tree):
    """Place a pytree of [B, ...] arrays with B sharded over 'data'."""
    def put(x):
        spec = P("data", *([None] * (x.ndim - 1)))
        return jax.device_put(x, NamedSharding(mesh, spec))
    return jax.tree_util.tree_map(put, tree)


def replicate(mesh: Mesh, tree):
    def put(x):
        return jax.device_put(x, NamedSharding(mesh, P()))
    return jax.tree_util.tree_map(put, tree)
