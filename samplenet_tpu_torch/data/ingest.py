"""Checksum-gated ingest of externally supplied datasets.

Mirrors samplenet_tpu/data/ingest.py:1-175 on the port's readers
(data/modelnet.py::load_h5, data/plyio.py). Nothing is downloaded: the
moment a ModelNet40 h5 tree or a ShapeNet PLY tree lands on disk,
`validate_modelnet40` / `validate_shapenet` check it against the official
schema and record per-file md5 checksums in a manifest beside it
(ingest_manifest.json, the JAX module's format), so that a later run can
show it read the same bytes; the trainers then take it with `--dataset
modelnet40 --h5-dir` or the ShapeNet `--data-dir`.

    python -m samplenet_tpu_torch.data.ingest modelnet40 --data-dir data
    python -m samplenet_tpu_torch.data.ingest shapenet --data-dir data/sn

The official ModelNet40 drop (`modelnet40_ply_hdf5_2048`) holds 5 train
and 2 test shards of [*, 2048, 3] float32 clouds with labels in [0, 40),
9,840 train and 2,468 test clouds, listed by {train,test}_files.txt
(classification/provider.py:14-19). Reading it needs h5py, which the
card's machine does not have: ModelNet validation runs on the CPU host.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

from samplenet_tpu_torch.data.modelnet import get_data_files, load_h5

OFFICIAL_MODELNET40 = {
    "train_clouds": 9840,
    "test_clouds": 2468,
    "points": 2048,
    "num_classes": 40,
}

MANIFEST = "ingest_manifest.json"


def _md5(path: str, chunk: int = 1 << 20) -> str:
    h = hashlib.md5()
    with open(path, "rb") as f:
        while block := f.read(chunk):
            h.update(block)
    return h.hexdigest()


def validate_modelnet40(data_dir: str, *, strict: bool = False) -> dict:
    """Validates an unpacked modelnet40_ply_hdf5_2048 tree: shapes, dtypes,
    the label range and the split lists always; with `strict` also the
    official cloud counts (a subset passes without it and is flagged
    official_counts false). Returns the manifest, also written beside the
    data."""
    root = os.path.join(data_dir, "modelnet40_ply_hdf5_2048")
    if not os.path.isdir(root):
        raise FileNotFoundError(
            f"{root} not found: unpack the official "
            "modelnet40_ply_hdf5_2048.zip there (no download attempted).")
    manifest: dict = {"root": root, "splits": {}, "files": {}}
    counts = {}
    for split in ("train", "test"):
        list_path = os.path.join(root, f"{split}_files.txt")
        if not os.path.exists(list_path):
            raise FileNotFoundError(f"missing split list {list_path}")
        total = 0
        for entry in get_data_files(list_path):
            path = entry if os.path.isabs(entry) else os.path.join(
                root, os.path.basename(entry))
            data, labels = load_h5(path)
            if data.ndim != 3 or data.shape[2] != 3:
                raise ValueError(
                    f"{path}: expected [*, N, 3], got {data.shape}")
            if data.shape[1] != OFFICIAL_MODELNET40["points"]:
                raise ValueError(
                    f"{path}: expected {OFFICIAL_MODELNET40['points']} "
                    f"points per cloud, got {data.shape[1]}")
            if labels.min() < 0 or \
                    labels.max() >= OFFICIAL_MODELNET40["num_classes"]:
                raise ValueError(f"{path}: labels outside [0, 40)")
            if not np.isfinite(data).all():
                raise ValueError(f"{path}: non-finite coordinates")
            manifest["files"][os.path.basename(path)] = {
                "md5": _md5(path), "clouds": int(data.shape[0])}
            total += data.shape[0]
        counts[split] = total
        manifest["splits"][split] = total
    official = (counts["train"] == OFFICIAL_MODELNET40["train_clouds"]
                and counts["test"] == OFFICIAL_MODELNET40["test_clouds"])
    manifest["official_counts"] = official
    if strict and not official:
        raise ValueError(
            f"cloud counts {counts} differ from the official split "
            f"({OFFICIAL_MODELNET40['train_clouds']}/"
            f"{OFFICIAL_MODELNET40['test_clouds']})")
    with open(os.path.join(root, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def validate_shapenet(data_dir: str, classes: tuple[str, ...] = ()) -> dict:
    """Validates a ShapeNetCore PLY tree (<data_dir>/<synset>/*.ply,
    reconstruction/src/in_out.py:23-36): every file checksummed (md5) and
    its header's vertex count recorded, and one sample PLY a class parsed
    whole to [N, 3]. Returns the manifest, also written to data_dir."""
    from samplenet_tpu_torch.data.plyio import load_ply, ply_vertex_count
    from samplenet_tpu_torch.data.shapenet import CATEGORY_TO_SYNSET

    manifest: dict = {"root": data_dir, "classes": {}, "files": {}}
    found_any = False
    for name in classes or tuple(CATEGORY_TO_SYNSET):
        syn = CATEGORY_TO_SYNSET.get(name, name)
        d = os.path.join(data_dir, syn)
        if not os.path.isdir(d):
            continue
        plys = sorted(f for f in os.listdir(d) if f.endswith(".ply"))
        if not plys:
            continue
        counts = set()
        for fname in plys:
            path = os.path.join(d, fname)
            n_pts = ply_vertex_count(path)   # raises on a truncated header
            if n_pts <= 0:
                raise ValueError(f"{path}: empty vertex element")
            counts.add(n_pts)
            manifest["files"][f"{syn}/{fname}"] = {
                "md5": _md5(path), "points": n_pts}
        pts = load_ply(os.path.join(d, plys[0]))
        if pts.ndim != 2 or pts.shape[1] != 3:
            raise ValueError(
                f"{d}/{plys[0]}: expected [N, 3], got {pts.shape}")
        manifest["classes"][name] = {
            "synset": syn, "files": len(plys),
            "sample_points": int(pts.shape[0]),
            "uniform_points": len(counts) == 1,
            "sample_md5": manifest["files"][f"{syn}/{plys[0]}"]["md5"],
        }
        found_any = True
    if not found_any:
        raise FileNotFoundError(
            f"no ShapeNet synset directories with .ply files under "
            f"{data_dir}")
    with open(os.path.join(data_dir, MANIFEST), "w") as f:
        json.dump(manifest, f, indent=1)
    return manifest


def main(argv=None) -> dict:
    p = argparse.ArgumentParser("ingest")
    p.add_argument("dataset", choices=["modelnet40", "shapenet"])
    p.add_argument("--data-dir", default="data")
    p.add_argument("--strict", action="store_true",
                   help="require the official ModelNet40 cloud counts")
    args = p.parse_args(argv)
    if args.dataset == "modelnet40":
        m = validate_modelnet40(args.data_dir, strict=args.strict)
    else:
        m = validate_shapenet(args.data_dir)
    print(json.dumps({k: v for k, v in m.items() if k != "files"}, indent=1))
    return m


if __name__ == "__main__":
    main()
