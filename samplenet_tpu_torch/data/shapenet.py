"""ShapeNetCore point clouds for the reconstruction track, numpy only.

A copy of samplenet_tpu/data/shapenet.py:19-166 (the port cannot import
the JAX package): the synset-id <-> category map, PLY loading in a thread
pool with the native C++ parser (runtime/), and the seeded 85/5/10
train/val/test split of reconstruction/src/in_out.py:188-217. The layout is
`<data_dir>/shape_net_core_uniform_samples_2048/<synset>/*.ply`.
"""

from __future__ import annotations

import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

# ShapeNetCore synsetId -> category (in_out.py:38-102)
SYNSET_TO_CATEGORY = {
    "02691156": "airplane", "02773838": "bag", "02801938": "basket",
    "02808440": "bathtub", "02818832": "bed", "02828884": "bench",
    "02834778": "bicycle", "02843684": "birdhouse", "02871439": "bookshelf",
    "02876657": "bottle", "02880940": "bowl", "02924116": "bus",
    "02933112": "cabinet", "02747177": "can", "02942699": "camera",
    "02954340": "cap", "02958343": "car", "03001627": "chair",
    "03046257": "clock", "03207941": "dishwasher", "03211117": "monitor",
    "04379243": "table", "04401088": "telephone", "02946921": "tin_can",
    "04460130": "tower", "04468005": "train", "03085013": "keyboard",
    "03261776": "earphone", "03325088": "faucet", "03337140": "file",
    "03467517": "guitar", "03513137": "helmet", "03593526": "jar",
    "03624134": "knife", "03636649": "lamp", "03642806": "laptop",
    "03691459": "speaker", "03710193": "mailbox", "03759954": "microphone",
    "03761084": "microwave", "03790512": "motorcycle", "03797390": "mug",
    "03928116": "piano", "03938244": "pillow", "03948459": "pistol",
    "03991062": "pot", "04004475": "printer", "04074963": "remote_control",
    "04090263": "rifle", "04099429": "rocket", "04225987": "skateboard",
    "04256520": "sofa", "04330267": "stove", "04530566": "vessel",
    "04554684": "washer", "02858304": "boat", "02992529": "cellphone",
}
CATEGORY_TO_SYNSET = {v: k for k, v in SYNSET_TO_CATEGORY.items()}


def ensure_dataset(data_dir: str) -> str:
    root = os.path.join(data_dir, "shape_net_core_uniform_samples_2048")
    if os.path.isdir(root):
        return root
    raise FileNotFoundError(
        f"ShapeNetCore samples not found at {root}; unpack "
        f"shape_net_core_uniform_samples_2048 there, or use the procedural "
        f"dataset")


def files_in_subdirs(top_dir: str, suffix: str = ".ply") -> list[str]:
    out = []
    for root, _, files in os.walk(top_dir):
        for fn in sorted(files):
            if fn.endswith(suffix):
                out.append(os.path.join(root, fn))
    return out


def load_point_clouds(file_names: list[str], num_points: int | None = None,
                      threads: int = 8) -> np.ndarray:
    """PLY files loaded in a thread pool -> [M, N, 3] float32, parsed by
    the native C++ parser (runtime/native/loader.cpp), as samplenet_tpu/
    data/shapenet.py:63-84 prefers it: ctypes releases the GIL during the
    call, so the threads parse in parallel. Raises where the parser cannot
    be built (runtime/loader.py); `plyio.load_ply` is the Python
    reader."""
    from samplenet_tpu_torch.runtime import load_ply_native

    def one(fn):
        pts = load_ply_native(fn)
        return pts[:num_points] if num_points else pts

    with ThreadPoolExecutor(max_workers=threads) as pool:
        clouds = list(pool.map(one, file_names))
    return np.stack(clouds).astype(np.float32)


def train_val_test_split(items, train_p: float = 0.85, val_p: float = 0.05,
                         seed: int | None = None):
    """85/5/10 split of an array or a list, shuffled by `seed`."""
    n = len(items)
    order = np.arange(n)
    if seed is not None:
        np.random.RandomState(seed).shuffle(order)
    n_train = int(round(train_p * n))
    n_val = int(round(val_p * n))
    idx = (order[:n_train], order[n_train:n_train + n_val],
           order[n_train + n_val:])
    if isinstance(items, np.ndarray):
        return tuple(items[i] for i in idx)
    arr = np.asarray(items, dtype=object)
    return tuple(list(arr[i]) for i in idx)


def load_category_split(data_dir: str, category: str, num_points: int = 2048,
                        seed: int | None = None):
    """One category's clouds, split 85/5/10 (train_ae.py:57-89 flow):
    (train, val, test), each [M, num_points, 3]."""
    root = ensure_dataset(data_dir)
    synset = CATEGORY_TO_SYNSET.get(category, category)
    files = files_in_subdirs(os.path.join(root, synset))
    empty = np.zeros((0, num_points, 3), np.float32)
    return tuple(load_point_clouds(part, num_points) if part else empty
                 for part in train_val_test_split(files, seed=seed))
