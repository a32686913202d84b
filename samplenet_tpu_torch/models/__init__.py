"""Models of the port (counterpart of samplenet_tpu/models)."""

from samplenet_tpu_torch.models.autoencoder import (  # noqa: F401
    ConvDecoder,
    PointNetAE,
)
from samplenet_tpu_torch.models.losses import (  # noqa: F401
    projection_loss,
    reconstruction_simplification_loss,
    simplification_loss,
)
from samplenet_tpu_torch.models.pcrnet import PCRNet, PointNetFeatures  # noqa: F401
from samplenet_tpu_torch.models.pointnet_cls import PointNetClassifier  # noqa: F401
from samplenet_tpu_torch.models.samplenet import (  # noqa: F401
    FPSSampler,
    RandomSampler,
    SampleNet,
    SimplificationNet,
)
from samplenet_tpu_torch.models.soft_projection import (  # noqa: F401
    SoftProjection,
    sigma_from_temperature,
)
