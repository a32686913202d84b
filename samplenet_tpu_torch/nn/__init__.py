"""Neural building blocks of the port (counterpart of samplenet_tpu/nn)."""

from samplenet_tpu_torch.nn.layers import MLPHead, PointMLP  # noqa: F401
