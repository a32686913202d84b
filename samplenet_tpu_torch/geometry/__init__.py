"""Quaternion algebra and rigid transforms of the registration track
(counterpart of samplenet_tpu/geometry)."""

from samplenet_tpu_torch.geometry.quaternion import (  # noqa: F401
    euler_to_quaternion,
    expmap_to_quaternion,
    qeuler,
    qfix,
    qinv,
    qmul,
    qrot,
    quaternion_to_rotation_matrix,
)
from samplenet_tpu_torch.geometry.transforms import (  # noqa: F401
    QuaternionTransform,
    create_random_transform,
    deg_to_rad,
    rad_to_deg,
)
