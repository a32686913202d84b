"""Utilities of the port (counterpart of samplenet_tpu/utils): run logging,
the sampler's shared CLI arguments (args.py), the checkpoint Configuration
(config.py), numpy point-cloud helpers and the profiling surface."""

from samplenet_tpu_torch.utils.logging import Logger  # noqa: F401
