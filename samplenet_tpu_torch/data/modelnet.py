"""ModelNet40 HDF5 loading and batch iteration, numpy only.

A copy of the loaders of samplenet_tpu/data/modelnet.py:40-137 (the port
cannot import the JAX package): the official `modelnet40_ply_hdf5_2048`
layout, {train,test}_files.txt listing h5 shards with "data" [n, 2048, 3]
and "label" [n, 1]. `iterate_batches` and `iterate_batches_padded` give
the JAX package's batches for the same RandomState; `save_h5` writes the
evaluation's dumps in that layout. h5py is imported only when a file is
read or written.
"""

from __future__ import annotations

import os
from collections.abc import Iterator

import numpy as np


def ensure_dataset(data_dir: str) -> str:
    root = os.path.join(data_dir, "modelnet40_ply_hdf5_2048")
    if os.path.isdir(root):
        return root
    raise FileNotFoundError(
        f"ModelNet40 not found at {root}; unpack modelnet40_ply_hdf5_2048 "
        f"there, or use the procedural dataset")


def get_data_files(list_path: str) -> list[str]:
    """The non-empty lines of a split list ({train,test}_files.txt)."""
    with open(list_path) as f:
        return [line.strip() for line in f if line.strip()]


def load_h5(path: str) -> tuple[np.ndarray, np.ndarray]:
    import h5py

    with h5py.File(path, "r") as f:
        data = f["data"][:]
        label = f["label"][:]
    return data.astype(np.float32), label.squeeze().astype(np.int32)


def save_h5(path: str, data: np.ndarray, label: np.ndarray | None = None,
            data_dtype: str = "float32", label_dtype: str = "uint8") -> None:
    """An h5 dump, gzip-compressed (data_prep_util.save_h5 semantics)."""
    import h5py

    with h5py.File(path, "w") as f:
        f.create_dataset("data", data=data, compression="gzip",
                         compression_opts=4, dtype=data_dtype)
        if label is not None:
            f.create_dataset("label", data=label, compression="gzip",
                             compression_opts=1, dtype=label_dtype)


def load_split(data_dir: str, split: str) -> tuple[np.ndarray, np.ndarray]:
    """All h5 shards of the official split, concatenated."""
    root = ensure_dataset(data_dir)
    datas, labels = [], []
    for fn in get_data_files(os.path.join(root, f"{split}_files.txt")):
        # entries look like "data/modelnet40_ply_hdf5_2048/ply_data_*.h5"
        path = fn if os.path.isabs(fn) else os.path.join(
            root, os.path.basename(fn))
        d, lab = load_h5(path)
        datas.append(d)
        labels.append(lab)
    return np.concatenate(datas), np.concatenate(labels)


def iterate_batches(data: np.ndarray, labels: np.ndarray, batch_size: int,
                    *, shuffle: bool = True, drop_last: bool = True,
                    rng: np.random.RandomState | None = None
                    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
    """Epoch iterator; shuffles cloud order (provider.shuffle_data)."""
    n = len(labels)
    order = np.arange(n)
    if shuffle:
        (rng or np.random).shuffle(order)
    end = n - (n % batch_size) if drop_last else n
    for s in range(0, end, batch_size):
        idx = order[s:s + batch_size]
        yield data[idx], labels[idx]


def iterate_batches_padded(data: np.ndarray, labels: np.ndarray,
                           batch_size: int
                           ) -> Iterator[tuple[np.ndarray, np.ndarray, int]]:
    """Full-coverage eval iterator: (batch, labels, real_count), the last
    batch padded by repeating its last cloud; callers keep [:real_count]."""
    n = len(labels)
    for s in range(0, n, batch_size):
        bx, by = data[s:s + batch_size], labels[s:s + batch_size]
        real = len(by)
        if real < batch_size:
            pad = batch_size - real
            bx = np.concatenate([bx, np.repeat(bx[-1:], pad, axis=0)])
            by = np.concatenate([by, np.repeat(by[-1:], pad, axis=0)])
        yield bx, by, real
