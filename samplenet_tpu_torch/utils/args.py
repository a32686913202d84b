"""The sampler's shared CLI arguments.

Mirrors samplenet_tpu/utils/args.py (registration/src/sputils.py:45-61
`get_parser`): the sampler flag set every entry point shares, with the
same names, aliases and defaults; a track's CLI adds its own flags.
"""

from __future__ import annotations

import argparse


def add_sampler_args(
    parser: argparse.ArgumentParser,
    *,
    num_out_points: int = 64,
    group_size: int = 8,
    alpha: float = 0.01,
    lmbda: float = 0.01,
    gamma: float = 1.0,
    delta: float = 0.0,
) -> argparse.ArgumentParser:
    parser.add_argument("--skip-projection", action="store_true",
                        help="do not project points in training")
    parser.add_argument("--num-in-points", type=int, default=1024,
                        help="number of input points")
    parser.add_argument("--num-out-points", type=int, default=num_out_points,
                        help="number of output points")
    parser.add_argument("--bottleneck-size", type=int, default=128)
    parser.add_argument("--alpha", type=float, default=alpha,
                        help="simplification loss weight")
    parser.add_argument("--gamma", type=float, default=gamma,
                        help="Lb constant regularisation weight")
    parser.add_argument("--delta", type=float, default=delta,
                        help="Lb linear regularisation weight")
    parser.add_argument("--projection-group-size", "--group-size",
                        dest="group_size", type=int, default=group_size,
                        help="neighbourhood size in soft projection")
    parser.add_argument("--lmbda", type=float, default=lmbda,
                        help="projection loss weight")
    return parser


def get_parser() -> argparse.ArgumentParser:
    """sputils.get_parser: a new parser with the shared flags."""
    parser = argparse.ArgumentParser(
        "SampleNet: Differentiable Point Cloud Sampling (PyTorch/CUDA)")
    return add_sampler_args(parser)
