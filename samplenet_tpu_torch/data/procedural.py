"""Procedural shape dataset: a self-contained ModelNet-style benchmark.

A numpy copy of samplenet_tpu/data/procedural.py (the port cannot import
the JAX package, whose __init__ imports jax): the same generators, in the
same order, drawing from the same np.random.RandomState, so
`make_dataset` gives the JAX package's arrays bit for bit for a seed.
24 classes, deliberately confusable pairs, per-sample warps, shears,
anisotropic scaling and noise, unit-sphere normalised like ModelNet40.
"""

from __future__ import annotations

import numpy as np

CLASS_NAMES = (
    "sphere", "ellipsoid", "cube", "rounded_cube",
    "cylinder", "tube", "capsule",
    "cone", "frustum", "hourglass",
    "torus", "torus_thick",
    "pyramid", "disk", "bowl", "paraboloid",
    "helix", "spring",
    "cross", "lshape", "box_frame",
    "star", "gear", "mobius",
)


def _unit_normalize(pts: np.ndarray) -> np.ndarray:
    pts = pts - pts.mean(0, keepdims=True)
    scale = np.max(np.linalg.norm(pts, axis=1))
    return pts / max(scale, 1e-8)


# ------------------------------------------------------------- primitives

def _sphere(rng, n):
    v = rng.randn(n, 3)
    return v / np.linalg.norm(v, axis=1, keepdims=True)


def _ellipsoid(rng, n):
    return _sphere(rng, n) * np.array([1.0, 0.5, 0.78])


def _superellipsoid(rng, n, p):
    """|x|^p + |y|^p + |z|^p = 1 surface; p=4 reads as a rounded cube."""
    d = _sphere(rng, n)
    r = (np.abs(d) ** p).sum(1, keepdims=True) ** (-1.0 / p)
    return d * r


def _cube(rng, n):
    axis = rng.randint(0, 3, n)
    sign = rng.choice([-1.0, 1.0], n)
    uv = rng.uniform(-1, 1, (n, 2))
    pts = np.empty((n, 3))
    rows = np.arange(n)
    pts[rows, axis] = sign
    other = np.stack([(axis + 1) % 3, (axis + 2) % 3], 1)
    pts[rows[:, None], other] = uv
    return pts


def _rounded_cube(rng, n):
    return _superellipsoid(rng, n, 4.0)


def _cylinder(rng, n):
    theta = rng.uniform(0, 2 * np.pi, n)
    z = rng.uniform(-1, 1, n)
    return np.stack([np.cos(theta), z, np.sin(theta)], 1)


def _tube(rng, n):
    """Hollow open cylinder: outer + inner walls and annulus end caps."""
    kind = rng.randint(0, 10, n)  # 0-3 outer, 4-7 inner, 8-9 caps
    theta = rng.uniform(0, 2 * np.pi, n)
    r = np.where(kind < 4, 1.0, 0.62)
    cap = kind >= 8
    r = np.where(cap, np.sqrt(rng.uniform(0.62**2, 1.0, n)), r)
    y = np.where(cap, rng.choice([-1.0, 1.0], n) * 0.75,
                 rng.uniform(-0.75, 0.75, n))
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], 1)


def _capsule(rng, n):
    s = _sphere(rng, n)
    pts = s.copy()
    pts[:, 1] += np.sign(s[:, 1]) * 0.8
    return pts


def _cone(rng, n):
    h = np.sqrt(rng.uniform(0, 1, n))  # area-uniform along height
    theta = rng.uniform(0, 2 * np.pi, n)
    r = 1.0 - h
    return np.stack([r * np.cos(theta), h * 2 - 1, r * np.sin(theta)], 1)


def _frustum(rng, n):
    """Truncated cone: radius 1 at the base tapering to 0.45 at the top."""
    h = np.sqrt(rng.uniform(0, 1, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    r = 1.0 - 0.55 * h
    return np.stack([r * np.cos(theta), h * 2 - 1, r * np.sin(theta)], 1)


def _hourglass(rng, n):
    """Two cones joined tip-to-tip at the origin."""
    y = rng.uniform(-1, 1, n)
    theta = rng.uniform(0, 2 * np.pi, n)
    r = np.abs(y)
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], 1)


def _torus(rng, n, rr=0.22):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(0, 2 * np.pi, n)
    x = (1 + rr * np.cos(v)) * np.cos(u)
    z = (1 + rr * np.cos(v)) * np.sin(u)
    y = rr * np.sin(v)
    return np.stack([x, y, z], 1)


def _torus_thick(rng, n):
    return _torus(rng, n, rr=0.5)


def _pyramid(rng, n):
    """Square base + 4 triangular faces (vectorised)."""
    apex = np.array([0.0, 1.5, 0.0])
    corners = np.array([[1, -1], [1, 1], [-1, 1], [-1, -1]], float)
    on_base = rng.randint(0, 2, n) == 0
    pts = np.empty((n, 3))
    base_uv = rng.uniform(-1, 1, (n, 2))
    pts[:, 0], pts[:, 1], pts[:, 2] = base_uv[:, 0], -1.0, base_uv[:, 1]
    # triangular faces: uniform barycentric via reflected square trick
    e = rng.randint(0, 4, n)
    a = np.stack([corners[e][:, 0], -np.ones(n), corners[e][:, 1]], 1)
    b_c = corners[(e + 1) % 4]
    b = np.stack([b_c[:, 0], -np.ones(n), b_c[:, 1]], 1)
    u, v = rng.uniform(0, 1, n), rng.uniform(0, 1, n)
    flip = u + v > 1
    u, v = np.where(flip, 1 - u, u), np.where(flip, 1 - v, v)
    tri = a + u[:, None] * (b - a) + v[:, None] * (apex[None] - a)
    pts[~on_base] = tri[~on_base]
    return pts


def _disk(rng, n):
    r = np.sqrt(rng.uniform(0, 1, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    y = rng.choice([-0.05, 0.05], n)
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], 1)


def _bowl(rng, n):
    """Hemispherical shell opening upward."""
    s = _sphere(rng, n)
    s[:, 1] = -np.abs(s[:, 1])
    return s


def _paraboloid(rng, n):
    r = np.sqrt(rng.uniform(0, 1, n))
    theta = rng.uniform(0, 2 * np.pi, n)
    y = 1.4 * r * r - 0.7
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], 1)


def _helix(rng, n, turns=2.0, radius=1.0, jitter=0.05):
    t = rng.uniform(0, 2 * np.pi * turns, n)
    noise = rng.randn(n, 3) * jitter
    pts = np.stack([radius * np.cos(t), t / (np.pi * turns) - 1,
                    radius * np.sin(t)], 1)
    return pts + noise


def _spring(rng, n):
    return _helix(rng, n, turns=5.0, radius=0.85, jitter=0.04)


def _cross(rng, n):
    # three orthogonal bars
    pick = rng.randint(0, 3, n)
    long_ = rng.uniform(-1, 1, n)
    short = rng.uniform(-0.2, 0.2, (n, 2))
    pts = np.empty((n, 3))
    rows = np.arange(n)
    pts[rows, pick] = long_
    other = np.stack([(pick + 1) % 3, (pick + 2) % 3], 1)
    pts[rows[:, None], other] = short
    return pts


def _lshape(rng, n):
    """Two orthogonal bars meeting at a corner."""
    on_first = rng.randint(0, 2, n) == 0
    t = rng.uniform(-1, 1, n)
    s = rng.uniform(-0.18, 0.18, (n, 2))
    pts = np.empty((n, 3))
    # bar 1 along x at y=-1; bar 2 along y at x=-1 (shared corner at (-1,-1))
    pts[on_first] = np.stack(
        [t[on_first], -1 + s[on_first, 0], s[on_first, 1]], 1)
    pts[~on_first] = np.stack(
        [-1 + s[~on_first, 0], t[~on_first], s[~on_first, 1]], 1)
    return pts


def _box_frame(rng, n):
    """The 12 edges of a cube (wireframe)."""
    edge_axis = rng.randint(0, 3, n)
    t = rng.uniform(-1, 1, n)
    signs = rng.choice([-1.0, 1.0], (n, 2))
    pts = np.empty((n, 3))
    rows = np.arange(n)
    pts[rows, edge_axis] = t
    other = np.stack([(edge_axis + 1) % 3, (edge_axis + 2) % 3], 1)
    pts[rows[:, None], other] = signs + rng.uniform(-0.05, 0.05, (n, 2))
    return pts


def _extruded_profile(rng, n, radius_fn, half_height):
    """Side wall + end caps of an extruded polar profile r = radius_fn(θ)."""
    theta = rng.uniform(0, 2 * np.pi, n)
    rmax = radius_fn(theta)
    on_cap = rng.uniform(0, 1, n) < 0.3
    r = np.where(on_cap, rmax * np.sqrt(rng.uniform(0, 1, n)), rmax)
    y = np.where(on_cap, rng.choice([-1.0, 1.0], n) * half_height,
                 rng.uniform(-half_height, half_height, n))
    return np.stack([r * np.cos(theta), y, r * np.sin(theta)], 1)


def _star(rng, n):
    return _extruded_profile(
        rng, n, lambda t: 0.55 + 0.45 * np.cos(5 * t), 0.3)


def _gear(rng, n):
    return _extruded_profile(
        rng, n, lambda t: 0.8 + 0.2 * np.tanh(4 * np.cos(8 * t)), 0.3)


def _mobius(rng, n):
    u = rng.uniform(0, 2 * np.pi, n)
    v = rng.uniform(-0.4, 0.4, n)
    x = (1 + v * np.cos(u / 2)) * np.cos(u)
    z = (1 + v * np.cos(u / 2)) * np.sin(u)
    y = v * np.sin(u / 2)
    return np.stack([x, y, z], 1)


_GENERATORS = (
    _sphere, _ellipsoid, _cube, _rounded_cube,
    _cylinder, _tube, _capsule,
    _cone, _frustum, _hourglass,
    _torus, _torus_thick,
    _pyramid, _disk, _bowl, _paraboloid,
    _helix, _spring,
    _cross, _lshape, _box_frame,
    _star, _gear, _mobius,
)

assert len(_GENERATORS) == len(CLASS_NAMES)


def make_cloud(label: int, num_points: int, rng: np.random.RandomState) -> np.ndarray:
    pts = _GENERATORS[label](rng, num_points)
    # intra-class deformation: smooth low-frequency warp -> shear ->
    # anisotropic scale -> up-axis rotation -> noise. The warp and shear are
    # what keep confusable class pairs genuinely overlapping.
    k = rng.uniform(0.8, 2.8, (3, 3))
    phase = rng.uniform(0, 2 * np.pi, (1, 3))
    amp = rng.uniform(0.0, 0.16, (1, 3))
    pts = pts + amp * np.sin(pts @ k.T + phase)
    shear = np.eye(3)
    i, j = rng.choice(3, 2, replace=False)
    shear[i, j] = rng.uniform(-0.25, 0.25)
    pts = pts @ shear.T
    scale = rng.uniform(0.6, 1.45, size=(1, 3))
    pts = pts * scale
    ang = rng.uniform(0, 2 * np.pi)
    c, s = np.cos(ang), np.sin(ang)
    rot = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]])
    pts = pts @ rot
    pts = pts + rng.randn(*pts.shape) * 0.012
    return _unit_normalize(pts).astype(np.float32)


def make_dataset(
    num_clouds: int,
    num_points: int = 1024,
    num_classes: int = len(_GENERATORS),
    seed: int = 0,
) -> tuple[np.ndarray, np.ndarray]:
    """Returns (data [num_clouds, num_points, 3], labels [num_clouds]).

    Labels are class-balanced (each class appears num_clouds/num_classes
    times, +-1) and shuffled deterministically by `seed`.
    """
    rng = np.random.RandomState(seed)
    labels = rng.permutation(
        np.arange(num_clouds) % num_classes).astype(np.int32)
    data = np.stack([make_cloud(int(l), num_points, rng) for l in labels])
    return data, labels
