"""Multi-process input pipeline: each rank feeds its own rows.

Mirrors samplenet_tpu/parallel/input_pipeline.py:1-82, with a data index
of the mesh for a JAX process. Each of the D data indices loads (or
keeps) 1/D of the dataset, the M ranks of its model group alike, draws
its rows of every global batch from the same shuffled order (the same
RandomState stream on every rank, so shard boundaries agree), and the
global batch is the concatenation of the data indices' rows, as
jax.make_array_from_process_local_data assembles it.
"""

from __future__ import annotations

from collections.abc import Iterator

import numpy as np

from samplenet_tpu_torch.parallel.mesh import Mesh, min_over_ranks


def host_shard(data: np.ndarray, labels: np.ndarray,
               mesh: Mesh | None = None) -> tuple[np.ndarray, np.ndarray]:
    """The rank's static share of a dataset: len // D rows from
    data_rank * (len // D), the remainder dropped (:19-27)."""
    if mesh is None or mesh.data_size == 1:
        return data, labels
    per = len(labels) // mesh.data_size
    sl = slice(mesh.data_rank * per, (mesh.data_rank + 1) * per)
    return data[sl], labels[sl]


def global_batches(mesh: Mesh | None, data: np.ndarray, labels: np.ndarray,
                   global_batch: int, *, shuffle: bool = True, seed: int = 0,
                   process_local: bool = False
                   ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Yields the rank's rows (global_batch / D of them) of each global
    batch (:30-82). With `process_local`, data and labels are already this
    rank's share (each rank loaded its own files) and lengths may differ
    across ranks: the batch count is then the minimum over the world (one
    all-reduce), without which a shorter rank would stop first and every
    other rank would hang in its next collective."""
    size = 1 if mesh is None else mesh.data_size
    if global_batch % size:
        raise ValueError(f"global batch {global_batch} is not divisible by "
                         f"the {size} data ranks of the mesh")
    local_batch = global_batch // size
    if process_local:
        local_data, local_labels = data, labels
    else:
        local_data, local_labels = host_shard(data, labels, mesh)
    order = np.arange(len(local_labels))
    if shuffle:
        np.random.RandomState(seed).shuffle(order)
    n_batches = len(order) // local_batch
    if process_local and mesh is not None and mesh.size > 1:
        n_batches = min_over_ranks(n_batches, mesh)
    for s in range(0, n_batches * local_batch, local_batch):
        idx = order[s:s + local_batch]
        yield local_data[idx], local_labels[idx]
