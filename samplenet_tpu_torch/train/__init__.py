"""Training of the port (counterpart of samplenet_tpu/train): the
classification-track sampler against a frozen PointNet and the
reconstruction track (the AE, then the sampler against the frozen AE),
their train state and checkpoints, and the `train_samplenet` and
`train_reconstruction` CLIs."""
