"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped without a CUDA device. These reach the kernels'
edge paths that `chip_smoke.py` does not: several query tiles and several
staged database chunks in nn_direction, exact distance ties, FPS with more
than 48 KB of shared memory, other MLP widths, and inputs the kernels
refuse. The machine with the card has no jax, so run them without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances: nn_direction and FPS bit for bit (same roundings, same
tie-breaks); point_mlp_max at rtol = atol = 1e-4 (f32 sums in another
order).
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _randn(rng, *shape, dev):
    return torch.from_numpy(
        rng.standard_normal(shape).astype(np.float32)).to(dev)


@pytest.mark.parametrize("b,n1,n2", [
    (2, 1024, 1024),   # 32 query tiles
    (3, 40, 5000),     # three database chunks, ragged tail
    (1, 1, 1),
])
def test_nn_direction_bit_equal(dev, b, n1, n2):
    from samplenet_tpu_torch.ops.cuda import nn_direction, nn_direction_plain

    rng = np.random.default_rng(n1 + n2)
    x, y = _randn(rng, b, n1, 3, dev=dev), _randn(rng, b, n2, 3, dev=dev)
    dk, ik = nn_direction(x, y)
    dp, ip = nn_direction_plain(x, y)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)


def test_nn_direction_ties_take_the_lowest_index(dev):
    from samplenet_tpu_torch.ops.cuda import nn_direction, nn_direction_plain

    rng = np.random.default_rng(0)
    base = _randn(rng, 2, 700, 3, dev=dev)
    y = torch.cat([base, base, base], dim=1).contiguous()  # every point 3x
    x = base[:, ::7].contiguous()
    dk, ik = nn_direction(x, y)
    dp, ip = nn_direction_plain(x, y)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    assert int(ik.max()) < 700


@pytest.mark.parametrize("b,n,k", [
    (3, 5000, 64),     # 80 KB of shared memory: the opt-in path
    (2, 7, 7),         # every point picked
    (4, 1000, 33),
])
def test_fps_bit_equal(dev, b, n, k):
    from samplenet_tpu_torch.ops.cuda import fps, fps_plain

    rng = np.random.default_rng(n + k)
    pts = _randn(rng, b, n, 3, dev=dev)
    given = torch.from_numpy(
        rng.integers(0, n, (b, k)).astype(np.int32)).to(dev)
    count = torch.from_numpy(
        rng.integers(1, k + 1, b).astype(np.int32)).to(dev)
    ik, xk = fps(pts, given, count, k)
    ip, xp = fps_plain(pts, given, count, k)
    assert torch.equal(ik, ip) and torch.equal(xk, xp)


def test_fps_ties_on_a_grid(dev):
    """Points on an integer grid have many equal distances."""
    from samplenet_tpu_torch.ops.cuda import fps_plain
    from samplenet_tpu_torch.ops.fps import farthest_point_sample_with_points

    g = torch.arange(10, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
    grid = grid.reshape(1, -1, 3)
    pts = grid.repeat(2, 1, 1).to(dev).contiguous()
    ik, xk = farthest_point_sample_with_points(
        40, pts, start_idx=torch.tensor([0, 555]))
    given = torch.zeros(2, 40, dtype=torch.int32, device=dev)
    given[:, 0] = torch.tensor([0, 555], dtype=torch.int32, device=dev)
    ip, xp = fps_plain(pts, given,
                       torch.ones(2, dtype=torch.int32, device=dev), 40)
    assert torch.equal(ik, ip) and torch.equal(xk, xp)


@pytest.mark.parametrize("widths,n", [
    ((3, 64, 64, 64, 128, 64), 130),     # bottleneck 64
    ((3, 64, 128, 128, 256, 128), 1000),  # reconstruction-track widths
    ((3, 64, 64, 64, 128, 128), 1),
])
def test_point_mlp_max_close(dev, widths, n):
    from samplenet_tpu_torch.ops.cuda import point_mlp_max, point_mlp_max_plain

    rng = np.random.default_rng(n)
    x = _randn(rng, 5, n, 3, dev=dev)
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        wbs += [_randn(rng, cin, cout, dev=dev) / cin ** 0.5,
                0.1 * _randn(rng, cout, dev=dev)]
    torch.testing.assert_close(point_mlp_max(x, tuple(wbs)),
                               point_mlp_max_plain(x, tuple(wbs)),
                               rtol=1e-4, atol=1e-4)


def test_kernels_refuse_what_they_do_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import fps, nn_direction, point_mlp_max

    pts = torch.zeros(1, 20000, 3, device=dev)   # 320 KB of shared memory
    with pytest.raises(ValueError, match="shared memory"):
        fps(pts, torch.zeros(1, 4, dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev), 4)
    x = torch.zeros(1, 8, 3, device=dev)
    with pytest.raises(ValueError, match="divisible by 4"):
        point_mlp_max(x, (torch.zeros(3, 6, device=dev),
                          torch.zeros(6, device=dev)))
    with pytest.raises(ValueError, match="contiguous"):
        nn_direction(torch.zeros(1, 3, 8, device=dev).transpose(1, 2), x)


def test_samplenet_kernel_path_matches_plain_path(dev):
    from samplenet_tpu_torch.models import SampleNet
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.matching import nn_match_from_clouds

    net = SampleNet(16, 64, generator=torch.Generator().manual_seed(1))
    net = net.to(dev).eval()
    x = _randn(np.random.default_rng(1), 5, 1000, 3, dev=dev)
    reset_launch_counts()
    with torch.inference_mode():
        sk, mk = net(x)
        counts = launch_counts()
        with plain_on_cuda():
            sp = net.simplify(x)
            # the plain matcher on the kernel path's own simplified cloud
            mp, _ = nn_match_from_clouds(x, sk, 16)
        assert launch_counts() == counts
    assert counts == {"point_mlp_max": 1, "nn_direction": 1, "fps": 1}
    torch.testing.assert_close(sk, sp, rtol=1e-4, atol=1e-4)
    assert torch.equal(mk, mp)
