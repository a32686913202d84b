"""Multi-process input pipeline: each rank feeds its own rows.

Mirrors samplenet_tpu/parallel/input_pipeline.py:1-82, with a rank of the
mesh for a JAX process. Each rank loads (or keeps) 1/W of the dataset,
draws its rows of every global batch from the same shuffled order (the
same RandomState stream on every rank, so shard boundaries agree), and
the global batch is the concatenation of the ranks' rows, as
jax.make_array_from_process_local_data assembles it.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from samplenet_tpu_torch.parallel.mesh import Mesh, min_over_ranks


def host_shard(data: np.ndarray, labels: np.ndarray,
               mesh: Mesh | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The rank's static share of a dataset: len // W rows from
    rank * (len // W), the remainder dropped (:19-27)."""
    if mesh is None or mesh.size == 1:
        return data, labels
    per = len(labels) // mesh.size
    sl = slice(mesh.rank * per, (mesh.rank + 1) * per)
    return data[sl], labels[sl]


def global_batches(mesh: Mesh | None, data: np.ndarray, labels: np.ndarray,
                   global_batch: int, *, shuffle: bool = True, seed: int = 0,
                   process_local: bool = False
                   ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields the rank's rows (global_batch / W of them) of each global
    batch (:30-82). With `process_local`, data and labels are already this
    rank's share (each rank loaded its own files) and lengths may differ
    across ranks: the batch count is then the minimum over the ranks (one
    all-reduce), without which a shorter rank would stop first and every
    other rank would hang in its next collective."""
    size = 1 if mesh is None else mesh.size
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"the {size} ranks of the mesh")
    local_batch = global_batch // size
    if process_local:
        local_data, local_labels = data, labels
    else:
        local_data, local_labels = host_shard(data, labels, mesh)
    order = np.arange(len(local_labels))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    n_batches = len(order) // local_batch
    if process_local and size > 1:
        n_batches = min_over_ranks(n_batches, mesh)
    for s in range(0, n_batches * local_batch, local_batch):
        idx = order[s:s + local_batch]
        yield local_data[idx], local_labels[idx]
