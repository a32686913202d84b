"""Per-cloud transforms for the registration input pipeline, numpy only.

A copy of samplenet_tpu/data/pctransforms.py:16-107 (the port cannot
import the JAX package), after registration/src/pctransforms.py:
angle-axis rotation, scale, translate, clipped jitter, random input
dropout (dropped points collapse to the first point, keeping shapes
static), and OnUnitCube normalisation (method2: scale by the largest
bounding-box extent, then re-centre, pctransforms.py:162-170). All
operate on a single [N, 3] numpy cloud with an explicit RandomState, so
the same seed gives the JAX package's clouds.
"""

from __future__ import annotations

import numpy as np


def angle_axis_matrix(angle: float, axis: np.ndarray) -> np.ndarray:
    """Rodrigues rotation matrix about `axis` by `angle` radians."""
    u = np.asarray(axis, np.float64)
    u = u / np.linalg.norm(u)
    c, s = np.cos(angle), np.sin(angle)
    cross = np.array([
        [0.0, -u[2], u[1]],
        [u[2], 0.0, -u[0]],
        [-u[1], u[0], 0.0],
    ])
    return (c * np.eye(3) + s * cross + (1 - c) * np.outer(u, u)).astype(np.float32)


class PointcloudScale:
    def __init__(self, lo: float = 0.8, hi: float = 1.25):
        self.lo, self.hi = lo, hi

    def __call__(self, points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        return points * rng.uniform(self.lo, self.hi)


class PointcloudRotate:
    def __init__(self, axis=(0.0, 1.0, 0.0)):
        self.axis = np.asarray(axis, np.float32)

    def __call__(self, points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        rot = angle_axis_matrix(rng.uniform() * 2 * np.pi, self.axis)
        return points @ rot.T


class PointcloudRotatePerturbation:
    def __init__(self, angle_sigma: float = 0.06, angle_clip: float = 0.18):
        self.sigma, self.clip = angle_sigma, angle_clip

    def __call__(self, points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        angles = np.clip(self.sigma * rng.randn(3), -self.clip, self.clip)
        rot = (angle_axis_matrix(angles[2], np.array([0, 0, 1.0]))
               @ angle_axis_matrix(angles[1], np.array([0, 1.0, 0]))
               @ angle_axis_matrix(angles[0], np.array([1.0, 0, 0])))
        return points @ rot.T


class PointcloudJitter:
    def __init__(self, std: float = 0.01, clip: float = 0.05):
        self.std, self.clip = std, clip

    def __call__(self, points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        noise = np.clip(self.std * rng.randn(*points.shape), -self.clip, self.clip)
        return points + noise.astype(points.dtype)


class PointcloudTranslate:
    def __init__(self, translate_range: float = 0.1):
        self.range = translate_range

    def __call__(self, points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        return points + rng.uniform(-self.range, self.range)


class PointcloudRandomInputDropout:
    """Dropped points are replaced by the first point (static shape)."""

    def __init__(self, max_dropout_ratio: float = 0.875):
        assert 0 <= max_dropout_ratio < 1
        self.max_ratio = max_dropout_ratio

    def __call__(self, points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        ratio = rng.random_sample() * self.max_ratio
        drop = rng.random_sample(len(points)) <= ratio
        out = points.copy()
        out[drop] = points[0]
        return out


class OnUnitCube:
    """Scale by the max bbox extent, then centre (method2 semantics)."""

    def __call__(self, points: np.ndarray,
                 rng: np.random.RandomState | None = None) -> np.ndarray:
        extent = points.max(0) - points.min(0)
        scaled = points / max(float(extent.max()), 1e-12)
        return scaled - scaled.mean(0, keepdims=True)


class Compose:
    def __init__(self, *transforms):
        self.transforms = transforms

    def __call__(self, points: np.ndarray, rng: np.random.RandomState) -> np.ndarray:
        for t in self.transforms:
            points = t(points, rng)
        return points
