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
order). The train kernels: soft_projection's idx bit for bit, its output
within 1e-5 and its gradients at rtol 1e-4 / atol 1e-5; point_mlp_exact's
outputs and statistics at rtol = atol = 1e-4 and its gradients at least
as accurate as the plain f32 version's (within 2x, or 1e-5 of their
scale), both measured against the plain version in float64; both
backward kernels bit for bit from run to run.
"""

import contextlib

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


def _exact_args(rng, b, n, widths, dev):
    x = _randn(rng, b, n, widths[0], dev=dev)
    layers = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        layers.append([_randn(rng, cin, cout, dev=dev) / cin ** 0.5,
                       0.1 * _randn(rng, cout, dev=dev),
                       1 + 0.1 * _randn(rng, cout, dev=dev),
                       0.1 * _randn(rng, cout, dev=dev)])
    return x, [list(t) for t in zip(*layers)]


def _exact_run(x, params, g, plain=False, dtype=torch.float32):
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_train_max
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    x = x.detach().to(dtype).clone().requires_grad_(True)
    params = [[t.detach().to(dtype).clone().requires_grad_(True)
               for t in group] for group in params]
    with plain_on_cuda() if plain else contextlib.nullcontext():
        pooled, means, vars_ = point_mlp_exact_train_max(x, *params)
    (pooled * g.to(dtype)).sum().backward()
    grads = [x.grad] + [t.grad for group in params for t in group]
    return pooled.detach(), list(means) + list(vars_), grads


@pytest.mark.parametrize("b,n", [(1, 1024), (3, 1000), (2, 65), (4, 1)])
def test_point_mlp_exact_matches_plain(dev, b, n):
    widths = (3, 64, 64, 64, 128, 128)
    rng = np.random.default_rng(b * 1000 + n)
    x, params = _exact_args(rng, b, n, widths, dev)
    g = _randn(rng, b, widths[-1], dev=dev)
    pk, sk, gk = _exact_run(x, params, g)
    pp, sp, gp = _exact_run(x, params, g, plain=True)
    _, _, gr = _exact_run(x, params, g, plain=True, dtype=torch.float64)
    torch.testing.assert_close(pk, pp, rtol=1e-4, atol=1e-4)
    for a, c in zip(sk, sp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-4)
    nl = len(widths) - 1
    for i, (a, c, r) in enumerate(zip(gk, gp, gr)):
        if 1 + nl <= i < 1 + 2 * nl:            # dense biases: exact zeros
            assert not a.any() and not c.any()
            continue
        # with few points (B*N = 4) BN's gradient is ill-conditioned, so
        # each f32 path is held to the f64 plain version instead
        scale = float(r.abs().max())
        ek = float((a.double() - r).abs().max()) / scale
        ep = float((c.double() - r).abs().max()) / scale
        assert ek <= max(2 * ep, 1e-5), (i, ek, ep)


def test_point_mlp_exact_backward_is_deterministic(dev):
    rng = np.random.default_rng(7)
    x, params = _exact_args(rng, 64, 1024, (3, 64, 128, 128), dev)
    g = _randn(rng, 64, 128, dev=dev)
    _, _, first = _exact_run(x, params, g)
    _, _, second = _exact_run(x, params, g)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def _soft_run(pts, qs, sigma, k, g, plain=False):
    from samplenet_tpu_torch.ops.cuda import soft_project
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    p, q, s = (t.clone().requires_grad_(True) for t in (pts, qs, sigma))
    with plain_on_cuda() if plain else contextlib.nullcontext():
        out, idx = soft_project(p, q, s, k)
    (out * g).sum().backward()
    return out.detach(), idx, (p.grad, q.grad, s.grad)


@pytest.mark.parametrize("k", [1, 16])
def test_soft_projection_ties_on_a_grid(dev, k):
    """Points on an integer grid and queries on grid points and cell
    centres: many equal distances, resolved to the lowest index."""
    g1 = torch.arange(8, dtype=torch.float32)
    grid = torch.stack(torch.meshgrid(g1, g1, g1, indexing="ij"), -1)
    pts = grid.reshape(1, -1, 3).repeat(2, 1, 1).to(dev).contiguous()
    qs = torch.cat([pts[:, ::37], pts[:, ::41] + 0.5], 1).contiguous()
    sigma = torch.tensor(0.5, device=dev)
    cot = _randn(np.random.default_rng(k), *qs.shape, dev=dev)
    ok, ik, gk = _soft_run(pts, qs, sigma, k, cot)
    op, ip, gp = _soft_run(pts, qs, sigma, k, cot, plain=True)
    assert torch.equal(ik, ip)
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5)
    for a, c in zip(gk, gp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


def test_soft_projection_backward_is_deterministic(dev):
    rng = np.random.default_rng(3)
    pts = _randn(rng, 16, 1024, 3, dev=dev)
    qs = _randn(rng, 16, 300, 3, dev=dev)
    sigma = torch.tensor(0.3, device=dev)
    cot = _randn(rng, 16, 300, 3, dev=dev)
    first = _soft_run(pts, qs, sigma, 7, cot)[2]
    second = _soft_run(pts, qs, sigma, 7, cot)[2]
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def test_train_kernels_refuse_what_they_do_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import (
        point_mlp_exact_train_max,
        soft_project,
    )

    pts = torch.zeros(1, 40, 3, device=dev)
    with pytest.raises(ValueError, match="k <= 16"):
        soft_project(pts, pts[:, :4].contiguous(),
                     torch.tensor(1.0, device=dev), 17)
    w = torch.zeros(3, 6, device=dev)
    v = torch.zeros(6, device=dev)
    with pytest.raises(ValueError, match="divisible by 4"):
        point_mlp_exact_train_max(pts, [w], [v], [v], [v])


def test_train_step_kernel_path_matches_plain_path(dev):
    from samplenet_tpu_torch.models import PointNetClassifier
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train.classification import (
        SampleNetConfig,
        create_samplenet_state,
        make_samplenet_train_step,
    )

    cfg = SampleNetConfig(batch_size=32)
    rng = np.random.default_rng(5)
    x = _randn(rng, 32, 1024, 3, dev=dev)
    y = torch.from_numpy(rng.integers(0, 40, 32)).to(dev)
    results = []
    for plain in (False, True):
        net, state = create_samplenet_state(cfg, device=dev, seed=1)
        cls = PointNetClassifier(40, generator=torch.Generator()
                                 .manual_seed(2)).to(dev)
        step = make_samplenet_train_step(net, cls, cfg, augment_data=False)
        reset_launch_counts()
        with plain_on_cuda() if plain else contextlib.nullcontext():
            m = step(state, x, y)
            torch.cuda.synchronize()
        results.append((m, launch_counts(),
                        {k: p.grad.clone() for k, p in
                         net.named_parameters()}))
    (mk, ck, gk), (mp, cp, gp) = results
    assert cp == {}
    for name in ("point_mlp_exact_fwd", "point_mlp_exact_bwd",
                 "soft_projection_fwd", "soft_projection_bwd"):
        assert ck.get(name) == 1, ck
    assert ck.get("nn_direction") == 2
    for k in mk:
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=1e-6)
    for name in gk:
        scale = float(gp[name].abs().max())
        torch.testing.assert_close(gk[name], gp[name], rtol=1e-3,
                                   atol=1e-5 + 1e-4 * scale)
