"""Datasets and augmentation of the port (counterpart of
samplenet_tpu/data): numpy loaders that give the JAX package's arrays,
on-device augmentation, and the registration track's rotated pairs
(`QuaternionFixedDataset`) and per-cloud transforms (`pctransforms`)."""

from samplenet_tpu_torch.data import augment, pctransforms  # noqa: F401
from samplenet_tpu_torch.data.modelnet import (  # noqa: F401
    iterate_batches,
    iterate_batches_padded,
    load_h5,
    load_split,
    save_h5,
)
from samplenet_tpu_torch.data.procedural import (  # noqa: F401
    CLASS_NAMES,
    make_dataset,
)
from samplenet_tpu_torch.data.qdataset import QuaternionFixedDataset  # noqa: F401
