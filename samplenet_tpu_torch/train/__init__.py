"""Training of the port (counterpart of samplenet_tpu/train): the
classification-track sampler against a frozen PointNet, its train state
and checkpoints, and the `train_samplenet` CLI."""
