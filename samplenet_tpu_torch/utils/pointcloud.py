"""General point-cloud utilities (reconstruction/src/general_utils.py parity):
random rotations, z-rotate + gaussian augmentation combo, complementary
indices, chunk iteration, and 3D scatter plotting (matplotlib imported
only inside the plot, so no path of the port needs it).

A copy of samplenet_tpu/utils/pointcloud.py, numpy only: the port cannot
import the JAX package."""

from __future__ import annotations

from collections.abc import Iterator, Sequence

import numpy as np


def rand_rotation_matrix(rng: np.random.RandomState | None = None) -> np.ndarray:
    """Uniform random 3D rotation (Arvo's method)."""
    rng = rng or np.random
    theta, phi, z = rng.uniform(size=3) * (2.0 * np.pi, 2.0 * np.pi, 2.0)
    r = np.sqrt(z)
    v = np.array([np.sin(phi) * r, np.cos(phi) * r, np.sqrt(2.0 - z)])
    st, ct = np.sin(theta), np.cos(theta)
    rot_z = np.array([[ct, st, 0], [-st, ct, 0], [0, 0, 1]])
    return ((np.outer(v, v) - np.eye(3)) @ rot_z).astype(np.float32)


def rotate_z(batch: np.ndarray, rng: np.random.RandomState | None = None,
             angle: float | None = None) -> np.ndarray:
    """Per-batch rotation about z (general_utils.py:100-110)."""
    rng = rng or np.random
    ang = rng.uniform(0, 2 * np.pi) if angle is None else angle
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], np.float32)
    return batch @ rot.T


def add_gaussian_noise(batch: np.ndarray, mu: float = 0.0, sigma: float = 0.02,
                       rng: np.random.RandomState | None = None) -> np.ndarray:
    rng = rng or np.random
    return batch + (mu + sigma * rng.randn(*batch.shape)).astype(batch.dtype)


def apply_augmentations(batch: np.ndarray, *, z_rotate: bool = False,
                        gauss_augment: dict | None = None,
                        rng: np.random.RandomState | None = None) -> np.ndarray:
    """general_utils.apply_augmentations flow: optional z-rotation then
    optional gaussian noise."""
    out = batch
    if z_rotate:
        out = rotate_z(out, rng)
    if gauss_augment is not None:
        out = add_gaussian_noise(out, gauss_augment.get("mu", 0.0),
                                 gauss_augment.get("sigma", 0.02), rng)
    return out


def complementary_points_idx(n: int, idx: Sequence[int]) -> np.ndarray:
    """Indices of the points NOT in idx (general_utils complementary set)."""
    mask = np.ones(n, bool)
    mask[np.asarray(idx)] = False
    return np.nonzero(mask)[0]


def iterate_in_chunks(items: Sequence, chunk: int) -> Iterator:
    for i in range(0, len(items), chunk):
        yield items[i : i + chunk]


def plot_3d_point_cloud(
    points: np.ndarray, *, show: bool = True, title: str | None = None,
    save_path: str | None = None, color=None, marker: str = ".",
    s: int = 8, elev: float = 10.0, azim: float = 240.0, axis=None,
):
    """3D scatter (general_utils.py:141-203). Matplotlib imported lazily so
    headless training never pays for it."""
    import matplotlib
    if save_path or not show:
        matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    if axis is None:
        fig = plt.figure()
        ax = fig.add_subplot(111, projection="3d")
    else:
        ax = axis
        fig = ax.figure
    ax.view_init(elev=elev, azim=azim)
    x, y, z = points[:, 0], points[:, 1], points[:, 2]
    sc = ax.scatter(x, y, z, marker=marker, s=s, c=color)
    if title:
        ax.set_title(title)
    lim = float(np.abs(points).max()) * 1.05
    ax.set_xlim(-lim, lim)
    ax.set_ylim(-lim, lim)
    ax.set_zlim(-lim, lim)
    if save_path:
        fig.savefig(save_path, dpi=120, bbox_inches="tight")
    if show and not save_path:
        plt.show()
    return fig, sc
