"""Training and evaluation of the port (counterpart of
samplenet_tpu/train): the classification track (the PointNet classifier,
the sampler against it frozen, the evaluation protocols), the
reconstruction track (the AE, then the sampler against the frozen AE)
and the progressive track, their train state and checkpoints, and the
`train_classifier`, `train_samplenet`, `evaluate_cli`,
`train_reconstruction` and `train_progressive` CLIs."""
