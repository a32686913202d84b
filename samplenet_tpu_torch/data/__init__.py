"""Datasets and augmentation of the port (counterpart of
samplenet_tpu/data): numpy loaders that give the JAX package's arrays,
and on-device augmentation."""

from samplenet_tpu_torch.data import augment  # noqa: F401
from samplenet_tpu_torch.data.modelnet import (  # noqa: F401
    iterate_batches,
    iterate_batches_padded,
    load_split,
)
from samplenet_tpu_torch.data.procedural import (  # noqa: F401
    CLASS_NAMES,
    make_dataset,
)
