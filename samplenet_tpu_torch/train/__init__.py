"""Training and evaluation of the port (counterpart of
samplenet_tpu/train): the classification track (the PointNet classifier,
the sampler against it frozen, the evaluation protocols), the
reconstruction track (the AE, then the sampler against the frozen AE),
the registration track (PCRNet, then the sampler against the frozen
PCRNet, scored by rotation error), and the progressive track, their
train state and checkpoints, and the `train_classifier`,
`train_samplenet`, `evaluate_cli`, `train_reconstruction`,
`train_registration` and `train_progressive` CLIs."""
