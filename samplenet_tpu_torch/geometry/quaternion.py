"""Quaternion algebra on torch tensors, (w, x, y, z) convention.

A copy of samplenet_tpu/geometry/quaternion.py:16-132 (the port cannot
import the JAX package): the Hamilton product, vector rotation in the
Rodrigues form, the inverse, euler conversions for the six axis orders,
antipodal fixing (numpy), the exponential map and the rotation matrix,
batched over any leading dimensions and differentiable under autograd
where the JAX versions are under `grad`. Each formula keeps the JAX
version's order of operations, so both round alike.
"""

from __future__ import annotations

import numpy as np
import torch


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the last axis, in jnp.cross's order of operations."""
    a0, a1, a2 = a.unbind(-1)
    b0, b1, b2 = b.unbind(-1)
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def qmul(q: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Hamilton product q*r; both [..., 4] wxyz."""
    w1, x1, y1, z1 = q.unbind(-1)
    w2, x2, y2, z2 = r.unbind(-1)
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], dim=-1)


def qrot(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vectors v [..., 3] by quaternions q [..., 4] (wxyz):
    v + 2 * (w * (u x v) + u x (u x v))."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    uuv = _cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


def qinv(q: torch.Tensor) -> torch.Tensor:
    """Conjugate (inverse for unit quaternions)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def qeuler(q: torch.Tensor, order: str = "xyz",
           epsilon: float = 0.0) -> torch.Tensor:
    """Quaternion -> intrinsic Euler angles for the six axis orders."""
    w, x, y, z = q.unbind(-1)

    def asin(v):
        return torch.asin(torch.clamp(v, -1 + epsilon, 1 - epsilon))

    atan2 = torch.atan2
    if order == "xyz":
        ex = atan2(2 * (w * x - y * z), 1 - 2 * (x * x + y * y))
        ey = asin(2 * (x * z + w * y))
        ez = atan2(2 * (w * z - x * y), 1 - 2 * (y * y + z * z))
    elif order == "yzx":
        ex = atan2(2 * (w * x - y * z), 1 - 2 * (x * x + z * z))
        ey = atan2(2 * (w * y - x * z), 1 - 2 * (y * y + z * z))
        ez = asin(2 * (x * y + w * z))
    elif order == "zxy":
        ex = asin(2 * (w * x + y * z))
        ey = atan2(2 * (w * y - x * z), 1 - 2 * (x * x + y * y))
        ez = atan2(2 * (w * z - x * y), 1 - 2 * (x * x + z * z))
    elif order == "xzy":
        ex = atan2(2 * (w * x + y * z), 1 - 2 * (x * x + z * z))
        ey = atan2(2 * (w * y + x * z), 1 - 2 * (y * y + z * z))
        ez = asin(2 * (w * z - x * y))
    elif order == "yxz":
        ex = asin(2 * (w * x - y * z))
        ey = atan2(2 * (x * z + w * y), 1 - 2 * (x * x + y * y))
        ez = atan2(2 * (x * y + w * z), 1 - 2 * (x * x + z * z))
    elif order == "zyx":
        ex = atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
        ey = asin(2 * (w * y - x * z))
        ez = atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    else:
        raise ValueError(f"unknown euler order {order!r}")
    return torch.stack([ex, ey, ez], dim=-1)


def qfix(q: np.ndarray) -> np.ndarray:
    """Enforce sign continuity along the leading (time) axis of [L, J, 4]."""
    out = q.copy()
    dots = np.sum(q[1:] * q[:-1], axis=-1)
    flip = (np.cumsum(dots < 0, axis=0) % 2).astype(bool)
    out[1:][flip] *= -1
    return out


def expmap_to_quaternion(e: torch.Tensor) -> torch.Tensor:
    """Axis-angle [..., 3] -> quaternion, sinc-stable near zero."""
    theta = torch.linalg.vector_norm(e, dim=-1, keepdim=True)
    w = torch.cos(0.5 * theta)
    xyz = 0.5 * torch.sinc(0.5 * theta / np.pi) * e
    return torch.cat([w, xyz], dim=-1)


def euler_to_quaternion(e: torch.Tensor, order: str = "xyz") -> torch.Tensor:
    """Euler angles [..., 3] -> quaternion, composing per-axis rotations,
    with the reference's antipodal flip for the orders xyz, yzx and zxy."""
    x, y, z = e.unbind(-1)
    zeros = torch.zeros_like(x)
    axis_q = {
        "x": torch.stack([torch.cos(x / 2), torch.sin(x / 2), zeros, zeros],
                         -1),
        "y": torch.stack([torch.cos(y / 2), zeros, torch.sin(y / 2), zeros],
                         -1),
        "z": torch.stack([torch.cos(z / 2), zeros, zeros, torch.sin(z / 2)],
                         -1),
    }
    result = None
    for ax in order:
        result = axis_q[ax] if result is None else qmul(result, axis_q[ax])
    if order in ("xyz", "yzx", "zxy"):
        result = -result
    return result


def quaternion_to_rotation_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion [..., 4] (wxyz) -> rotation matrix [..., 3, 3]."""
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], -1),
    ], dim=-2)
