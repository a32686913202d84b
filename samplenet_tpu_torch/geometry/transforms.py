"""Rigid 7-dof transforms (quaternion + translation) and the registration
track's error metrics, on torch tensors.

A copy of samplenet_tpu/geometry/transforms.py:24-111: QuaternionTransform
over [B, 7] twist vectors, its inverse (conjugate quaternion, negated
translation), batched point rotation, and the three evaluation errors:
the PCN rotation error 2*acos(2<q1,q2>^2 - 1), the deviation-from-identity
norm error ||R1 R2^T - I||_F^2 and mean |t1 - t2|. The JAX version is a
pytree for jit; here it is a plain frozen dataclass holding a tensor.
`create_random_transform` stays numpy, for dataset generation.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from samplenet_tpu_torch.geometry import quaternion as Q


def deg_to_rad(deg):
    return np.pi / 180 * deg


def rad_to_deg(rad):
    return 180 / np.pi * rad


@dataclass(frozen=True)
class QuaternionTransform:
    """[B, 7] twist: 4 quaternion (wxyz) + 3 translation components."""

    vec: torch.Tensor
    inversion: bool = False

    @property
    def quat(self) -> torch.Tensor:
        return self.vec[..., 0:4]

    @property
    def trans(self) -> torch.Tensor:
        return self.vec[..., 4:7]

    def inverse(self) -> "QuaternionTransform":
        vec = torch.cat([Q.qinv(self.quat), -self.trans], dim=-1)
        return QuaternionTransform(vec, inversion=not self.inversion)

    def rotate(self, p: torch.Tensor) -> torch.Tensor:
        """Rotate [B, N, 3] points (or [N, 3] with a single transform)."""
        if p.dim() == 2:
            q = self.quat.reshape(-1)[None, :4].expand(p.shape[0], 4)
            return Q.qrot(q, p)
        q = self.quat[:, None, :].expand(*p.shape[:2], 4)
        return Q.qrot(q, p)

    def apply(self, p: torch.Tensor) -> torch.Tensor:
        """Rotation then translation; the inverse translates first."""
        if self.inversion:
            return self.rotate(p + self.trans[:, None, :])
        return self.rotate(p) + self.trans[:, None, :]

    def rotation_errors(self, other: "QuaternionTransform") -> torch.Tensor:
        """Per-sample PCN rotation errors [B] in radians, no batch mean
        (precision curves need per-sample errors)."""
        dot = (self.quat * other.quat).sum(-1)
        return 2.0 * torch.arccos(torch.clamp(2.0 * dot ** 2 - 1.0, -1.0, 1.0))

    def compute_errors(self, other: "QuaternionTransform"
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(rot_err [rad], norm_err, trans_err), each batch-meaned."""
        q1, q2 = self.quat, other.quat
        dot = (q1 * q2).sum(-1)
        rot_err = torch.mean(
            2.0 * torch.arccos(torch.clamp(2.0 * dot ** 2 - 1.0, -1.0, 1.0)))
        r1 = Q.quaternion_to_rotation_matrix(q1)
        r2 = Q.quaternion_to_rotation_matrix(q2)
        rel = torch.einsum("bij,bkj->bik", r1, r2)
        eye = torch.eye(3, dtype=rel.dtype, device=rel.device)
        norm_err = torch.mean(((rel - eye) ** 2).sum((1, 2)))
        trans_err = torch.mean(torch.sqrt((self.trans - other.trans) ** 2))
        return rot_err, norm_err, trans_err


def create_random_transform(rng: np.random.RandomState,
                            max_rotation_deg: float = 45.0,
                            max_translation: float = 0.0) -> np.ndarray:
    """One [1, 7] twist with uniform euler angles in +-max_rotation_deg
    (qdataset.py:122-130): the angles, then the translation, drawn from
    `rng` in that order; the quaternion computed in f32, as the JAX
    version computes it."""
    max_rot = deg_to_rad(max_rotation_deg)
    euler = rng.uniform(-max_rot, max_rot, (1, 3))
    quat = Q.euler_to_quaternion(
        torch.from_numpy(euler.astype(np.float32)), "xyz").numpy()
    trans = rng.uniform(-max_translation, max_translation, (1, 3))
    return np.concatenate([quat, trans], axis=1).astype(np.float32)
