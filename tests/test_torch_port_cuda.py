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
order). The EMD: its cost within rtol 2e-4 of the plain version in
float64, and each gradient no further from that than 1.5x the plain f32
version's error (or 5e-4 of its scale), as tests/test_emd_kernel.py
holds the TPU kernel, both by the largest entry's error and norm-wise;
the kernel and the plain f32 version run on the same inputs, the input
and copies moved by one ulp, and each is held by its worst: where the
steep levels meet near-ties, either f32 path can drift from the f64
match. The train kernels: soft_projection's idx bit for bit, its output
within 1e-5 and its gradients at rtol 1e-4 / atol 1e-5; point_mlp_exact's
outputs and statistics at rtol = atol = 1e-4 and its gradients at least
as accurate as the plain f32 version's (within 2x, or 1e-5 of their
scale), both measured against the plain version in float64; both
backward kernels bit for bit from run to run. nn_snap bit for bit (dist,
idx, snapped), and snapped equal to the database point at idx. The ghost
chain point_mlp_train: the kernel and the plain version in the same mode
each against the plain version in float64 with bf16 off, the kernel's
error at most twice the plain version's (or 1e-4 of scale) by the
largest entry and norm-wise (in bf16 they sum z in other orders, so a
rounding can land one bf16 ulp apart); in bf16 also, norm-wise against
the plain bf16 version, the outputs within 1e-3 and the backward kernel
within 1e-3 of the plain VJP on the kernel forward's own state;
dense-bias gradients exactly 0; the backward bit for bit from run to run.
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


@pytest.mark.parametrize("b,n,widths", [
    (1, 1024, (3, 64, 64, 64, 128, 128)),
    (3, 1000, (3, 64, 64, 64, 128, 128)),
    (2, 65, (3, 64, 64, 64, 128, 128)),
    (4, 1, (3, 64, 64, 64, 128, 128)),
    # 625 tiles: pmt_bwd_dw's split-K runs are of unequal length
    (40, 1000, (3, 64, 64, 64, 128, 128)),
    # 64 -> 512: pmt_bwd_dz in 32-point tiles, 2 points a thread, op(W)^T
    # in K chunks
    (2, 300, (3, 64, 512)),
])
def test_point_mlp_exact_matches_plain(dev, b, n, widths):
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


@pytest.mark.parametrize("b,widths", [
    (64, (3, 64, 128, 128)),
    (1024, (3, 64, 64, 64, 128, 128)),     # the train step's shape
])
def test_point_mlp_exact_backward_is_deterministic(dev, b, widths):
    rng = np.random.default_rng(7)
    x, params = _exact_args(rng, b, 1024, widths, dev)
    g = _randn(rng, b, widths[-1], dev=dev)
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


def _rel_err(t, ref):
    return float((t.double() - ref).abs().max() / ref.abs().max().clamp_min(
        1e-30))


def _norm_err(t, ref):
    return float((t.double() - ref).norm() / ref.norm().clamp_min(1e-30))


def _share_off(t, ref, frac=1e-3):
    """Share of entries further from ref than frac of ref's largest."""
    return float(((t.double() - ref).abs() > frac * ref.abs().max())
                 .double().mean())


def _ulp_moves(x, gen):
    """x with each element moved by at most one ulp, at random."""
    step = torch.randint(-1, 2, x.shape, generator=gen, device=x.device)
    up = torch.nextafter(x, torch.full_like(x, float("inf")))
    down = torch.nextafter(x, torch.full_like(x, -float("inf")))
    return torch.where(step > 0, up, torch.where(step < 0, down, x))


@pytest.mark.parametrize("b,n,m", [
    (3, 96, 160),      # ragged row tile, factorr 1 / factorl 1
    (2, 128, 64),      # n = 2m: factorl 1, factorr 2
    (2, 64, 192),      # m = 3n: factorl 3
    (1, 1000, 1000),   # B=1, ragged
    (3, 2048, 64),
])
def test_emd_matches_plain_and_f64(dev, b, n, m):
    """The cost within rtol 2e-4 of the plain version in f64. The kernel
    and the plain f32 version run on the same four inputs, the input and
    three copies moved by one ulp, each against the plain version in f64
    on that input: where the auction meets a near-tie, one ulp moves f32's
    match, and which f32 path drifts further on one input is chance (at
    (3, 2048, 64) the plain version's largest error is 0.072 of scale on
    the input itself and the kernel's 0.142). Over the four, the kernel's
    worst error, both the largest entry's (as a share of the f64 scale)
    and norm-wise, is at most 1.5x the plain version's worst, or 5e-4.
    The readings are printed (pytest -s). The cost is bit-equal with and
    without gradients; without them the gradients are zero; every output
    is bit-equal from run to run."""
    from samplenet_tpu_torch.ops.cuda import emd_cost, emd_cost_plain

    rng = np.random.default_rng(b * 10000 + n + m)
    x1, x2 = _randn(rng, b, n, 3, dev=dev), _randn(rng, b, m, 3, dev=dev)
    ck, g1k, g2k = emd_cost(x1, x2)
    cr, _, _ = emd_cost_plain(x1.double(), x2.double())
    torch.testing.assert_close(ck.double(), cr, rtol=2e-4, atol=0)
    gen = torch.Generator(device=dev).manual_seed(n + m)
    # worst[path][gradient] = (largest entry's error, norm-wise, share off)
    worst = np.zeros((2, 2, 3))
    for moved in range(4):
        a, c = (x1, x2) if moved == 0 else (_ulp_moves(x1, gen),
                                            _ulp_moves(x2, gen))
        _, r1, r2 = emd_cost_plain(a.double(), c.double())
        for i, fn in enumerate((emd_cost, emd_cost_plain)):
            _, h1, h2 = fn(a, c)
            for j, (h, r) in enumerate(((h1, r1), (h2, r2))):
                worst[i, j] = np.maximum(worst[i, j], (
                    _rel_err(h, r), _norm_err(h, r), _share_off(h, r)))
    print(f"\nemd ({b}, {n}, {m}) over 4 inputs, g1 then g2, (largest "
          f"entry's error, norm-wise error, share of entries off by more "
          f"than 1e-3 of the largest): kernel {worst[0].tolist()}, plain "
          f"f32 {worst[1].tolist()}")
    limit = np.maximum(1.5 * worst[1, :, :2], 5e-4)
    assert (worst[0, :, :2] <= limit).all(), worst
    c0, z1, z2 = emd_cost(x1, x2, with_grads=False)
    assert torch.equal(c0, ck) and not z1.any() and not z2.any()
    again = emd_cost(x1, x2)
    assert all(torch.equal(a, c) for a, c in zip(again, (ck, g1k, g2k)))


def test_emd_refuses_what_it_does_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import emd_cost
    from samplenet_tpu_torch.ops.cuda.emd_kernel import emd_cost_cuda

    x = torch.zeros(1, 8, 3, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        emd_cost(x, torch.zeros(1, 6000, 3, device=dev))
    with pytest.raises(TypeError, match="float32"):
        emd_cost_cuda(x.double(), x.double())


@pytest.mark.parametrize("b,n", [(3, 1000), (8, 2048)])
def test_point_mlp_exact_at_the_reconstruction_widths(dev, b, n):
    """3->64->128->128->256->128: pmt_bwd_dz holds op(W)^T of 128->256
    and 256->128 in K chunks, and pmt_bwd_dw takes them whole (no
    input-channel slabs). Held as the classification widths are, with
    a floor of 1e-4 of scale: at these point counts both f32 paths land
    about 1e-6 to 1e-4 of scale from f64, either one ahead per tensor."""
    widths = (3, 64, 128, 128, 256, 128)
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
        if 1 + nl <= i < 1 + 2 * nl:
            assert not a.any() and not c.any()
            continue
        assert _rel_err(a, r) <= max(2 * _rel_err(c, r), 1e-4), i
    _, _, again = _exact_run(x, params, g)
    assert all(torch.equal(a, c) for a, c in zip(gk, again))


def test_recon_train_steps_launch_every_kernel(dev):
    """One AE step on the EMD loss and one SampleNet step against the
    frozen AE at 2048 points, then the NRE evaluation with SampleNet and
    with FPS: every kernel of the track launches."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import reconstruction as rec

    x = _randn(np.random.default_rng(9), 4, 2048, 3, dev=dev)
    acfg = rec.AEConfig(loss="emd", batch_size=4)
    ae, astate = rec.create_ae_state(acfg, device=dev)
    scfg = rec.SampleNetAEConfig(batch_size=4)
    sampler, sstate = rec.create_sampler_ae_state(scfg, device=dev)
    reset_launch_counts()
    loss = rec.make_ae_train_step(ae, acfg)(astate, x)
    m = rec.make_sampler_ae_train_step(sampler, ae, scfg, "emd")(sstate, x)
    rep = rec.evaluate_nre(rec.make_sampler_ae_eval_step(sampler, ae),
                           sstate, x.cpu().numpy(), 4, device=dev)
    fps = rec.evaluate_nre(rec.make_fps_ae_eval_step(ae, 64), sstate,
                           x.cpu().numpy(), 4, device=dev)
    counts = launch_counts()
    for name in ("emd", "point_mlp_exact_fwd", "point_mlp_exact_bwd",
                 "point_mlp_max", "nn_direction", "fps",
                 "soft_projection_fwd", "soft_projection_bwd"):
        assert counts.get(name, 0) > 0, counts
    assert bool(torch.isfinite(loss)) and all(
        bool(torch.isfinite(v)) for v in m.values())
    assert np.isfinite(rep["nre"]) and np.isfinite(fps["nre"])


# ------------------------------------------------ nn_snap and the ghost chain

@pytest.mark.parametrize("b,n1,n2", [
    (1, 1, 1),
    (2, 1, 5000),       # N2 > kChunk: three staged chunks, one query
    (3, 1000, 2500),    # N1 not a multiple of the query tile, N2 > kChunk
    (32, 1024, 1024),   # the progressive infer step
])
def test_nn_snap_bit_equal(dev, b, n1, n2):
    from samplenet_tpu_torch.ops.cuda import nn_snap, nn_snap_plain

    rng = np.random.default_rng(n1 * 7 + n2)
    x, y = _randn(rng, b, n1, 3, dev=dev), _randn(rng, b, n2, 3, dev=dev)
    dk, ik, sk = nn_snap(x, y)
    dp, ip, sp = nn_snap_plain(x, y)
    assert torch.equal(dk, dp) and torch.equal(ik, ip) and torch.equal(sk, sp)
    assert torch.equal(sk, torch.gather(y, 1, ik.long()[..., None]
                                        .expand(-1, -1, 3)))


def test_nn_snap_ties_and_nan(dev):
    """Every database point three times (ties to the lowest index), a NaN
    database point (never nearest) and NaN queries (all +inf: index 0)."""
    from samplenet_tpu_torch.ops.cuda import nn_snap, nn_snap_plain

    rng = np.random.default_rng(11)
    base = _randn(rng, 2, 700, 3, dev=dev)
    y = torch.cat([base, base, base], dim=1).contiguous()
    y[:, 5] = float("nan")
    x = torch.cat([base[:, ::7], torch.full((2, 3, 3), float("nan"),
                                            device=dev)], 1).contiguous()
    dk, ik, sk = nn_snap(x, y)
    dp, ip, sp = nn_snap_plain(x, y)
    assert torch.equal(dk, dp) and torch.equal(ik, ip)
    assert torch.equal(torch.nan_to_num(sk), torch.nan_to_num(sp))
    assert int(ik[:, :-3].max()) < 1400 and not ik[:, -3:].any()
    assert torch.isinf(dk[:, -3:]).all()


def _ghost_args(rng, b, n, widths, dev):
    x, params = _exact_args(rng, b, n, widths, dev)
    return x, params, _randn(rng, b, widths[-1], dev=dev)


def _ghost_run(x, params, g, bb, bf16, plain=False, dtype=torch.float32):
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_max
    from samplenet_tpu_torch.ops.dispatch import plain_on_cuda

    x = x.detach().to(dtype).clone().requires_grad_(True)
    params = [[t.detach().to(dtype).clone().requires_grad_(True)
               for t in group] for group in params]
    with plain_on_cuda() if plain else contextlib.nullcontext():
        pooled, means, vars_ = point_mlp_train_max(x, *params, block_b=bb,
                                                   bf16=bf16)
    (pooled * g.to(dtype)).sum().backward()
    torch.cuda.synchronize()
    grads = [x.grad] + [t.grad for group in params for t in group]
    return [pooled.detach(), *means, *vars_], grads


def _bwd_gap(x, params, g, bb) -> float:
    """Worst norm-wise distance of the bf16 backward kernel's gradients
    from the plain VJP run on the kernel forward's own state (its stored
    xhat and argmax)."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt

    weights, _, gammas, betas = params
    saved = pmt.point_mlp_train_fwd_cuda(x, weights, gammas, betas, 1e-5,
                                         bb, True)[3]
    kernel = pmt.point_mlp_train_bwd_cuda(x, weights, gammas, betas, 1e-5,
                                          bb, True, saved, g)
    zs, mus, rstds, argmax = saved
    p = x.shape[0] // bb
    xhats = [((z.view(p, -1, z.shape[-1]) - mu[:, None]) * rstd[:, None])
             .to(torch.bfloat16).float() for z, mu, rstd in zip(zs, mus, rstds)]
    plain = pmt.point_mlp_train_vjp_plain(x, weights, gammas, betas, 1e-5,
                                          bb, True, xhats, argmax.long(), g)
    flat = lambda gr: [gr[0], *gr[1], *gr[2], *gr[3]]  # noqa: E731
    return max(_norm_err(a, r) for a, r in zip(flat(kernel), flat(plain)))


def _ghost_check(x, params, g, bb, bf16, floor=1e-4):
    """Kernel and plain version in the same mode, each against the plain
    version in float64 with bf16 off: the kernel's error at most twice the
    plain version's (or `floor` of scale), by the largest entry and
    norm-wise; dense-bias gradients exactly 0; the backward bit-equal run
    to run. In bf16 also the roundings themselves, norm-wise against the
    plain bf16 version: outputs within 1e-3, and the backward within 1e-3
    of the plain VJP on the kernel forward's state (chip_smoke.py holds
    the same, with a control). Returns the worst (kernel, plain) error."""
    nl = len(params[0])
    ok, gk = _ghost_run(x, params, g, bb, bf16)
    op, gp = _ghost_run(x, params, g, bb, bf16, plain=True)
    orf, gr = _ghost_run(x, params, g, bb, False, plain=True,
                         dtype=torch.float64)
    worst = (0.0, 0.0)
    for i, (a, c, r) in enumerate(zip(ok + gk, op + gp, orf + gr)):
        if 1 + nl <= i - len(ok) < 1 + 2 * nl:      # dense biases
            assert not a.any() and not c.any(), i
            continue
        for err in (_rel_err, _norm_err):
            ek, ep = err(a, r), err(c, r)
            assert ek <= max(2 * ep, floor), (i, err.__name__, ek, ep)
            worst = max(worst, (ek, ep))
    _, again = _ghost_run(x, params, g, bb, bf16)
    assert all(torch.equal(a, c) for a, c in zip(gk, again))
    if bf16:
        out_gap = max(_norm_err(a, c) for a, c in zip(ok, op))
        bwd_gap = _bwd_gap(x, params, g, bb)
        print(f"bf16 against plain bf16: outputs {out_gap!r}, backward "
              f"{bwd_gap!r}")
        assert out_gap <= 1e-3 and bwd_gap <= 1e-3, (out_gap, bwd_gap)
    return worst


@pytest.mark.parametrize("b,n,bb,bf16", [
    (3, 256, 1, True),       # bb = 1
    (3, 256, 1, False),
    (64, 128, 64, False),    # bb = 64: one block of every cloud
    (8, 1000, 4, True),      # N not a multiple of the 64-point tile
    (8, 1000, 4, False),
    (6, 512, 2, True),       # bb = 2
    (6, 512, 2, False),
])
def test_point_mlp_train_matches_plain(dev, b, n, bb, bf16):
    rng = np.random.default_rng(b * 1000 + n + bf16)
    x, params, g = _ghost_args(rng, b, n, (3, 64, 64, 64, 128, 128), dev)
    _ghost_check(x, params, g, bb, bf16)


def test_point_mlp_train_at_the_reconstruction_widths(dev):
    """The AE's 256-wide layers in bf16 at B=50, N=2048, where
    auto_block_b gives bb = 1 (pmt_bwd_dz with op(W)^T in K chunks)."""
    from samplenet_tpu_torch.ops.cuda import auto_block_b

    widths = (3, 64, 128, 128, 256, 128)
    assert auto_block_b(50, 2048, widths[1:], True) == 1
    x, params, g = _ghost_args(np.random.default_rng(50), 50, 2048, widths,
                               dev)
    _ghost_check(x, params, g, 1, True)


def test_point_mlp_train_refuses_what_it_does_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_max

    pts = torch.zeros(2, 128, 3, device=dev)
    w, v = torch.zeros(3, 6, device=dev), torch.zeros(6, device=dev)
    with pytest.raises(ValueError, match="divisible by 4"):
        point_mlp_train_max(pts, [w], [v], [v], [v], block_b=1)


def test_progressive_ae_step_passes_a_gradient_through_the_frozen_ae(dev):
    """A progressive AE step on the card: every prefix of the projected
    cloud (16 .. 256 points, so also at and above the eval kernel's 128)
    crosses the frozen AE under autograd, and the sampler's conv layers
    get a nonzero gradient; the ghost chain (--fused-train) launches."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import progressive as prog
    from samplenet_tpu_torch.train import reconstruction as rec

    x = _randn(np.random.default_rng(12), 4, 512, 3, dev=dev)
    ae, _ = rec.create_ae_state(rec.AEConfig(num_points=512, batch_size=4),
                                device=dev)
    cfg = rec.SampleNetAEConfig(num_out_points=256, batch_size=4,
                                fused_train=True)
    sampler, state = rec.create_sampler_ae_state(cfg, device=dev)
    pcfg = prog.ProgressiveAEConfig(max_num_out_points=256, batch_size=4)
    reset_launch_counts()
    m = prog.make_progressive_ae_train_step(sampler, ae, pcfg)(state, x)
    torch.cuda.synchronize()
    counts = launch_counts()
    assert all(bool(torch.isfinite(v)) for v in m.values())
    for name in ("point_mlp_train_fwd", "point_mlp_train_bwd",
                 "soft_projection_fwd", "soft_projection_bwd",
                 "nn_direction"):
        assert counts.get(name, 0) > 0, counts
    assert "point_mlp_max" not in counts         # no prefix took it
    for i in range(1, 6):
        grad = getattr(sampler, f"conv{i}").weight.grad
        assert grad is not None and bool(grad.abs().max() > 0), i


def test_prefix_nre_takes_strided_prefixes(dev):
    """evaluate_ae_prefix_nre feeds the frozen AE prefix slices of the
    matched cloud (strided views); from 128 points on they take the eval
    kernel, which the kernel path and the plain path agree on."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import progressive as prog
    from samplenet_tpu_torch.train import reconstruction as rec

    data = np.random.default_rng(13).standard_normal(
        (6, 512, 3)).astype(np.float32)
    ae, _ = rec.create_ae_state(rec.AEConfig(num_points=512, batch_size=4),
                                device=dev)
    sampler, state = rec.create_sampler_ae_state(
        rec.SampleNetAEConfig(num_out_points=256, batch_size=4), device=dev)
    sizes = prog.progressive_sizes(16, 256)
    reset_launch_counts()
    got = prog.evaluate_ae_prefix_nre(sampler, state, ae, data, sizes, 4,
                                      device=dev)
    assert launch_counts().get("point_mlp_max", 0) > 0
    with plain_on_cuda():
        want = prog.evaluate_ae_prefix_nre(sampler, state, ae, data, sizes,
                                           4, device=dev)
    for s in sizes:
        for key in ("loss_sampled", "loss_full", "nre"):
            assert np.isfinite(got[s][key])
            np.testing.assert_allclose(got[s][key], want[s][key], rtol=1e-4)
