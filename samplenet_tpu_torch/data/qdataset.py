"""Registration dataset: fixed per-index random rotations (+ optional noise).

A numpy copy of samplenet_tpu/data/qdataset.py:29-83 (registration/src/
qdataset.py:133-179): every index gets a fixed, seed-deterministic random
rotation; `repeat` replays the base data under other transforms; noise
is fresh or fixed per index. The same seeds give the JAX package's
twists, clouds, noise and batch order. Batches are numpy (p0 template,
p1 source, igt twist [B, 7]).
"""

from __future__ import annotations

import numpy as np

from samplenet_tpu_torch.geometry import transforms as T


def _qrot_np(q: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Numpy quaternion rotation (wxyz): the per-sample path stays on the
    host, as the reference rotates in numpy."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    uuv = np.cross(u, uv)
    return v + 2.0 * (w * uv + uuv)


class QuaternionFixedDataset:
    def __init__(self, data: np.ndarray, repeat: int = 1, seed: int = 0,
                 apply_noise: bool = False, fixed_noise: bool = False,
                 noise_scale: float = 0.04):
        self.data = np.asarray(data, np.float32)  # [M, N, 3]
        self.len_data = len(self.data)
        self.len_set = self.len_data * repeat
        rng = np.random.RandomState(seed)
        self.twists = np.concatenate(
            [T.create_random_transform(rng, 45.0, 0.0)
             for _ in range(self.len_set)])  # [len_set, 7]
        self.apply_noise = apply_noise
        self.fixed_noise = fixed_noise
        self.noise_scale = noise_scale
        self.noise = None
        if fixed_noise:
            n = self.data.shape[1]
            self.noise = (noise_scale * rng.randn(self.len_set, n, 3)).astype(
                np.float32)
        self._noise_rng = np.random.RandomState(seed + 1)

    def __len__(self) -> int:
        return self.len_set

    def __getitem__(self, index: int):
        p0 = self.data[index % self.len_data]
        twist = self.twists[index]
        q = np.broadcast_to(twist[None, :4], (p0.shape[0], 4))
        p1 = _qrot_np(q, p0)
        if self.apply_noise:
            if self.fixed_noise:
                p1 = p1 + self.noise[index]
            else:
                p1 = p1 + self.noise_scale * self._noise_rng.randn(
                    *p1.shape).astype(np.float32)
        return p0, p1.astype(np.float32), twist

    def batches(self, batch_size: int, *, shuffle: bool = True,
                rng: np.random.RandomState | None = None,
                drop_last: bool = True):
        order = np.arange(self.len_set)
        if shuffle:
            (rng or np.random).shuffle(order)
        end = self.len_set - (self.len_set % batch_size) if drop_last \
            else self.len_set
        for s in range(0, end, batch_size):
            idx = order[s:s + batch_size]
            p0s, p1s, twists = zip(*(self[i] for i in idx))
            yield np.stack(p0s), np.stack(p1s), np.stack(twists)
