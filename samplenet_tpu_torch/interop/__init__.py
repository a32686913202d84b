"""Weights carried between the JAX package and the port (counterpart of
samplenet_tpu/interop)."""

from samplenet_tpu_torch.interop.jax_import import (  # noqa: F401
    autoencoder_state_dict_from_jax,
    conv_decoder_state_dict_from_jax,
    infer_pcrnet_config,
    infer_pointnet_config,
    infer_samplenet_config,
    load_sampler_weights,
    pcrnet_state_dict_from_jax,
    pointnet_state_dict_from_jax,
    samplenet_state_dict_from_jax,
)
