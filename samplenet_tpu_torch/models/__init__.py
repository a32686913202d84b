"""Models of the port (counterpart of samplenet_tpu/models)."""

from samplenet_tpu_torch.models.autoencoder import PointNetAE  # noqa: F401
from samplenet_tpu_torch.models.pointnet_cls import PointNetClassifier  # noqa: F401
from samplenet_tpu_torch.models.samplenet import (  # noqa: F401
    SampleNet,
    SimplificationNet,
)
from samplenet_tpu_torch.models.soft_projection import SoftProjection  # noqa: F401
