"""The CUDA kernels against their plain PyTorch versions, on the card.

Marked `cuda` and skipped without a CUDA device. These reach the kernels'
edge paths that `chip_smoke.py` does not: several query tiles and several
staged database chunks in nn_direction, exact distance ties, FPS with more
than 48 KB of shared memory, other MLP widths, and inputs the kernels
refuse. The machine with the card has no jax, so run them without the
suite's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_port_cuda.py -q

Tolerances: nn_direction and FPS bit for bit (same roundings, same
tie-breaks, NaN first in the 1-NN ops and ranked above every number in
FPS's argmax; NaN distances compared by place, FPS's and nn_snap's points
by their bits); FPS also under every launch plan, nn_direction and
nn_snap under every (lanes, queries) at every shape the paths give them,
across many staged chunks and over more query tiles than a grid axis of
65535 holds; point_mlp_max at rtol = atol = 1e-4 (f32 sums in another
order). The EMD: its cost within rtol 2e-4 of the plain version in
float64, and each gradient no further from that than 1.5x the plain f32
version's error (or 5e-4 of its scale), as tests/test_emd_kernel.py
holds the TPU kernel, both by the largest entry's error and norm-wise;
the kernel and the plain f32 version run on the same inputs, the input
and copies moved by one ulp, and each is held by its worst: where the
steep levels meet near-ties, either f32 path can drift from the f64
match. The train kernels: soft_projection's idx bit for bit, its output
within 1e-5 (NaN where the plain version's is: a NaN query) and its
gradients at rtol 1e-4 / atol 1e-5, its forward's outputs bit for bit
under every launch plan, its backward's bit for bit under other launch
plans and from run to run, also where one point takes every entry and
at N = 16384; point_mlp_exact's
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
The T-net classifier's forward on the card within rtol 1e-4 (atol 1e-5
of scale) of the CPU's; the matched evaluation on the kernel path against
the plain path: unique NN counts equal, nn matching's points bit for bit,
emd matching's points each path's own argmax's, at most 0.5% of the
argmaxes different between the paths (the f32 auction's chaos), and on
the clouds with equal points the correctness equal and the NLL at rtol
1e-4. The registration sampler step at full width on the kernel path
against the plain path: launches, loss terms at rtol 1e-4, and each
path's gradients against a float64 step replaying its own 1-NN and
neighbour choices, the kernel's error at most twice the plain path's (or
1e-4 norm-wise). The bf16 modes: point_mlp_max and the exact chain with
bf16 operands against their plain bf16 versions, norm-wise within 1e-3
(the chain's backward on its own forward state, bit for bit from run to
run), the f32 kernels as a control that must exceed it. The exact chain
and the ghost chain under a 2-rank data-parallel mesh (gloo ranks
sharing the card, parallel/launch.py), the ghost blocks straddling the
ranks: outputs and statistics within rtol = atol = 1e-4 of the
one-process kernel run, gradients within 2x the larger of the
one-process kernel's and plain f32 run's errors against float64 (or
1e-5 of scale; the ranks run the same kernels, and where a ReLU kink
puts the one-process kernel itself far from float64, as the exact chain
at B = 64, N = 256 here, 4e-3 of scale in dx, they land with it), both
kernels launched on each rank. Wide and odd widths: the exact chain at a
bottleneck of 1024 (pmt_bwd_dz in chunks of output channels, the
partial sums in registers, or carried through dh_prev from 512 inputs
on) and at 130 (padded to 132) by the exact chain's rule, its backward
bit for bit under other chunk widths and from run to run; the ghost
chain and point_mlp_max (f32 and bf16) at 130 and 1024 against their
plain versions by their rules, each launched. Group sizes above 16 on
the wide soft-projection kernels, and clouds beyond one FPS block on its
cluster variant (N above 16,384 up to 2^20, streamed past 131,072 points,
k = N = 8192, every cluster size C and R), by the same rules as the kernels
they extend: idx bit-equal, out within 1e-5, gradients at rtol 1e-4 /
atol 1e-5, the backward bit for bit across plans and runs; FPS's idx
and xyz bit for bit; today's shapes still on today's kernels.
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


# (B, N1, N2) of every shape the paths give the 1-NN kernel (chip_smoke.py's
# NN_SHAPES): the eval forward and the Chamfer loss (B=1024), the
# reconstruction sampler (B=50), the progressive steps at each prefix size
# s, both ways (B=32 over 1024 points; B=50 over 2048), the infer step's
# snap, and the registration steps (B=32: PCRNet's Chamfer 1024 over 1024,
# the sampler's 64 over 1024 and back, and 64 over 64 on the samples)
NN_PATH_SHAPES = sorted({
    (1024, 32, 1024), (1024, 1024, 32), (50, 64, 2048), (50, 2048, 64),
    (32, 64, 64),
    *((32, s, 1024) for s in (8, 16, 32, 64, 128, 256, 512, 1024)),
    *((32, 1024, s) for s in (8, 16, 32, 64, 128, 256, 512)),
    *((50, s, 2048) for s in (16, 32, 64, 128, 256, 512, 1024, 2048)),
    *((50, 2048, s) for s in (16, 32, 64, 128, 256, 512, 1024))})


def _nn_check_plans(x, y, plans):
    """nn_direction and nn_snap under each plan bit-equal to the plain
    version: idx, dist (NaN by place) and the snapped points' bits."""
    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck

    dp, ip, sp = ck.nn_snap_plain(x, y)
    for plan in plans:
        for snap in (False, True):
            out = ck.launch(x, y, plan, snap)
            assert torch.equal(out[1], ip) and _same_or_nan(out[0], dp), \
                (plan, snap, int((out[1] != ip).sum()))
            assert not snap or _same_bits(out[2], sp), plan


@pytest.mark.parametrize("b,n1,n2", NN_PATH_SHAPES)
def test_nn_every_plan_at_the_paths_shapes(dev, b, n1, n2):
    """Every (lanes, queries) the kernel takes, forced, at each shape the
    paths give it: the outputs do not depend on the plan."""
    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck
    from samplenet_tpu_torch.ops.cuda import nn_plan

    rng = np.random.default_rng(b * 7 + n1 + n2)
    x, y = _randn(rng, b, n1, 3, dev=dev), _randn(rng, b, n2, 3, dev=dev)
    plans = nn_plan.candidates(b, n1, n2)
    assert ck.kernel_plan(x.device.index, b, n1, n2) in plans
    assert len(plans) == len(nn_plan.LANES) * len(nn_plan.QUERIES)
    _nn_check_plans(x, y, plans)


def test_nn_n2_16384_across_chunks(dev):
    """Many staged chunks (two buffers in turn), NaN and a tie in late
    ones; every lanes count."""
    from samplenet_tpu_torch.ops.cuda import nn_plan

    rng = np.random.default_rng(16384)
    x, y = _randn(rng, 2, 100, 3, dev=dev), _randn(rng, 2, 16384, 3, dev=dev)
    y[0, 16000] = y[0, 3]
    y[1, 15000, 2] = float("nan")
    x[0, 7] = y[0, 3]
    plans = [p for p in nn_plan.candidates(2, 100, 16384) if p.queries == 2]
    assert {p.chunk for p in plans} == {nn_plan.nn_chunk(16384)}
    assert 16384 // nn_plan.nn_chunk(16384) >= 8
    _nn_check_plans(x, y, plans)


def test_nn_more_query_tiles_than_a_grid_axis_of_65535(dev):
    """N1 = 32 * 65535 + 1 queries over 8 points at B=1: the flat grid runs
    it (a (B, tiles) grid of 32-query tiles could not)."""
    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck
    from samplenet_tpu_torch.ops.cuda import nn_plan

    n1 = 32 * 65535 + 1
    rng = np.random.default_rng(n1)
    x, y = _randn(rng, 1, n1, 3, dev=dev), _randn(rng, 1, 8, 3, dev=dev)
    d, i = ck.nn_direction(x, y)
    dp, ip = ck.nn_direction_plain(x, y)
    assert torch.equal(d, dp) and torch.equal(i, ip)
    _nn_check_plans(x, y, [nn_plan.make(n1, 8, 32, 1),
                           nn_plan.make(n1, 8, 1, 8)])


def test_nn_launch_refuses_a_plan_the_kernel_does_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import chamfer_kernel as ck
    from samplenet_tpu_torch.ops.cuda import nn_plan

    x = torch.zeros(1, 10, 3, device=dev)
    for bad in (nn_plan.NnPlan(3, 4, 8, 1024), nn_plan.NnPlan(4, 4, 8, 100),
                nn_plan.NnPlan(4, 4, 9, 1024)):
        with pytest.raises(ValueError):
            ck.launch(x, x, bad)


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


def _same_bits(a, c):
    """Bit-equal tensors (NaN == NaN where the bits agree)."""
    return torch.equal(a.view(torch.int32), c.view(torch.int32))


def _same_or_nan(a, c):
    """Equal where finite or infinite, NaN at the same places."""
    return (torch.equal(a.isnan(), c.isnan())
            and torch.equal(a.masked_fill(a.isnan(), 0),
                            c.masked_fill(c.isnan(), 0)))


def _fps_given(rng, b, n, k, counts, dev):
    given = rng.integers(0, n, (b, k)).astype(np.int32)
    count = {"one": np.ones(b), "all": np.full(b, k),
             "random": rng.integers(1, k + 1, b)}[counts].astype(np.int32)
    return (torch.from_numpy(given).to(dev), torch.from_numpy(count).to(dev))


def _fps_check(pts, given, count, k, plan=None):
    from samplenet_tpu_torch.ops.cuda import fps, fps_plain
    from samplenet_tpu_torch.ops.cuda import fps_kernel

    if plan is None:
        ik, xk = fps(pts, given, count, k)
    else:
        ik, xk = fps_kernel.launch(pts, given, count, k, plan)
    ip, xp = fps_plain(pts, given, count, k)
    assert torch.equal(ik, ip), (ik != ip).sum()
    assert _same_bits(xk, xp)
    return ik


FPS_COUNTS = ("one", "random", "all")


@pytest.mark.parametrize("counts", FPS_COUNTS)
@pytest.mark.parametrize("kind", ["nan_x_given", "nan_y_picked", "nan_z",
                                  "inf", "minus_inf", "all_nan", "grid_nan"])
def test_fps_nan_and_inf_clouds_bit_equal(dev, kind, counts):
    """NaN ranks above every number and propagates through the running
    minimum; +-inf coordinates give inf or NaN distances; xyz compared by
    their bits."""
    rng = np.random.default_rng(len(kind) * 7 + len(counts))
    b, n, k = 4, 1000, 33
    pts = _randn(rng, b, n, 3, dev=dev)
    given, count = _fps_given(rng, b, n, k, counts, dev)
    nan = float("nan")
    if kind == "nan_x_given":
        pts[:, 17, 0] = nan
        given[:, 0] = 17
    elif kind == "nan_y_picked":
        pts[:, 600, 1] = nan
        given[:, 0] = 0
    elif kind == "nan_z":
        pts[0, 999, 2] = nan
        pts[2, 3, 2] = nan
    elif kind == "inf":
        pts[:, 40, 0] = float("inf")
        pts[1, 41, 0] = float("inf")
    elif kind == "minus_inf":
        pts[:, 500, 2] = float("-inf")
        pts[3, 7] = float("-inf")
    elif kind == "all_nan":
        pts[1] = nan
    else:                              # grid ties with a NaN point
        g = torch.arange(10, dtype=torch.float32, device=dev)
        grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
        pts = grid.reshape(1, -1, 3).repeat(b, 1, 1).contiguous()
        pts[2, 123, 1] = nan
    ik = _fps_check(pts.contiguous(), given, count, k)
    if kind == "all_nan" and counts == "one":
        assert not ik[1, 1:].any()        # every distance NaN: index 0


@pytest.mark.parametrize("counts", FPS_COUNTS)
@pytest.mark.parametrize("n", [7, 31, 1000, 2048, 5000])
@pytest.mark.parametrize("b", [1, 50, 1024])
def test_fps_at_the_plans_boundary_shapes(dev, b, n, counts):
    rng = np.random.default_rng(b * 7 + n)
    k = min(n, 33)
    pts = _randn(rng, b, n, 3, dev=dev)
    given, count = _fps_given(rng, b, n, k, counts, dev)
    _fps_check(pts, given, count, k)


@pytest.mark.parametrize("b,n,k", [(3, 7, 7), (2, 1000, 33), (2, 2048, 64),
                                   (1, 5000, 16)])
def test_fps_under_every_plan(dev, b, n, k):
    """The outputs do not depend on the launch plan: every plan the kernel
    takes for the cloud, the shared-memory variant included."""
    from samplenet_tpu_torch.ops.cuda import fps_plan

    rng = np.random.default_rng(n + k)
    pts = _randn(rng, b, n, 3, dev=dev)
    pts[0, n // 2, 1] = float("nan")
    given, count = _fps_given(rng, b, n, k, "random", dev)
    plans = fps_plan.candidates(n)
    assert plans[-1].shared
    for plan in plans:
        _fps_check(pts, given, count, k, plan)


@pytest.mark.parametrize("kind", ["nan_point", "nan_point_second_chunk",
                                  "nan_query", "inf_point", "mixed"])
def test_nn_direction_and_snap_on_nan_clouds(dev, kind):
    """NaN first, as the plain versions (amin, argmin) and the JAX
    package's chunked_min_argmin give it: a NaN distance wins, the first
    NaN index; a NaN query gets dist NaN and index 0."""
    from samplenet_tpu_torch.ops.cuda import (
        nn_direction,
        nn_direction_plain,
        nn_snap,
        nn_snap_plain,
    )

    rng = np.random.default_rng(len(kind))
    b, n1, n2 = 3, 70, 5000
    x, y = _randn(rng, b, n1, 3, dev=dev), _randn(rng, b, n2, 3, dev=dev)
    nan = float("nan")
    if kind == "nan_point":
        y[0, 5, 1] = nan
        y[0, 900, 0] = nan
    elif kind == "nan_point_second_chunk":
        y[1, 3000, 2] = nan
    elif kind == "nan_query":
        x[2, 11] = nan
        x[0, 69, 0] = nan
    elif kind == "inf_point":
        y[:, 7, 0] = float("inf")
        x[1, 3, 0] = float("inf")
    else:
        y[2, 4000, 0] = nan
        x[2, 1, 1] = nan
        y[0, 0] = float("-inf")
    dk, ik = nn_direction(x, y)
    dp, ip = nn_direction_plain(x, y)
    assert torch.equal(ik, ip) and _same_or_nan(dk, dp)
    dk, ik, sk = nn_snap(x, y)
    dp, ip, sp = nn_snap_plain(x, y)
    assert torch.equal(ik, ip) and _same_or_nan(dk, dp)
    assert _same_bits(sk, sp)
    if kind.startswith("nan_point"):
        hit = ik == (5 if kind == "nan_point" else 3000)
        assert hit[0 if kind == "nan_point" else 1].all()
    if kind == "nan_query":
        assert ik[2, 11] == 0 and torch.isnan(dk[2, 11])


@pytest.mark.parametrize("widths,n", [
    ((3, 64, 64, 64, 128, 64), 130),     # bottleneck 64
    ((3, 64, 128, 128, 256, 128), 1000),  # reconstruction-track widths
    ((3, 64, 64, 64, 128, 128), 1),
    ((3, 64, 64, 64, 128, 130), 300),     # padded to 132
    ((3, 18, 130), 77),
    ((3, 64, 64, 64, 128, 1024), 1024),   # bottleneck 1024
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


@pytest.mark.parametrize("widths,b,n", [
    ((3, 12, 20), 5, 1),
    ((3, 12, 20), 3, 1000),
    ((3, 64, 64, 64, 128, 128), 2, 77),
    ((3, 64, 128, 128, 256, 128), 3, 2048),  # 256-wide layers
])
def test_point_mlp_max_against_f64(dev, widths, b, n):
    """The kernel (split TF32 on the tensor cores, FP32 FMAs where cin < 8)
    and the plain f32 version, each against the plain version in float64:
    the kernel within 1e-4 of the plain f32 path and at least as close to
    f64 (within 2x, or 1e-5 of scale); one TF32 product would land about
    3e-4 of scale away."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_max, point_mlp_max_plain

    rng = np.random.default_rng(b * 100 + n)
    x = _randn(rng, b, n, widths[0], dev=dev)
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        wbs += [_randn(rng, cin, cout, dev=dev) / cin ** 0.5,
                0.1 * _randn(rng, cout, dev=dev)]
    k = point_mlp_max(x, tuple(wbs))
    p = point_mlp_max_plain(x, tuple(wbs))
    r = point_mlp_max_plain(x.double(), tuple(t.double() for t in wbs))
    torch.testing.assert_close(k, p, rtol=1e-4, atol=1e-4)
    ek, ep = _rel_err(k, r), _rel_err(p, r)
    print(f"point_mlp_max {widths} B={b} N={n} against f64: kernel {ek!r}, "
          f"plain f32 {ep!r}")
    assert ek <= max(2 * ep, 1e-5), (ek, ep)


@pytest.mark.parametrize("widths,b,n", [
    ((3, 12, 20), 5, 1),
    ((3, 12, 20), 3, 1000),
    ((3, 64, 64, 64, 128, 128), 64, 1024),
    ((3, 64, 128, 128, 256, 128), 8, 2048),
])
def test_train_forward_is_deterministic_and_f32_accurate(dev, widths, b, n):
    """The exact chain's forward kernels: z and the f64 statistics rows
    bit-equal from run to run; pooled, means and variances no further from
    the plain version in float64 than twice the plain f32 version (or
    1e-5 of scale). The share of each layer's z bit-equal to the plain
    version's is printed: the kernel sums in the plain matmul's order, so
    layer 0's should be all of it (above it, the statistics the two take
    in other orders may move an input by an ulp)."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme

    rng = np.random.default_rng(b + n)
    x, (ws, _, gs, bes) = _exact_args(rng, b, n, widths, dev)
    first = pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5)
    again = pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5)
    zs, zs2 = first[3][0], again[3][0]
    assert all(torch.equal(a, c) for a, c in zip(zs, zs2))
    assert all(torch.equal(a, c) for a, c in zip(first[1] + first[2],
                                                 again[1] + again[2]))
    plain = pme.point_mlp_exact_fwd_plain(x, ws, gs, bes, 1e-5)
    ref = pme.point_mlp_exact_fwd_plain(
        x.double(), [t.double() for t in ws], [t.double() for t in gs],
        [t.double() for t in bes], 1e-5)
    worst = (0.0, 0.0)
    for k, p, r in zip([first[0], *first[1], *first[2]],
                       [plain[0], *plain[1], *plain[2]],
                       [ref[0], *ref[1], *ref[2]]):
        ek, ep = _rel_err(k, r), _rel_err(p, r)
        assert ek <= max(2 * ep, 1e-5), (ek, ep)
        worst = max(worst, (ek, ep))
    same = [float((a == c).double().mean()) for a, c in zip(zs, plain[3][0])]
    print(f"exact forward {widths} B={b} N={n} against f64: kernel "
          f"{worst[0]!r}, plain f32 {worst[1]!r}; share of z bit-equal to "
          f"the plain version's, by layer: {same}")


def test_kernels_refuse_what_they_do_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import (
        fps,
        fps_plain,
        nn_direction,
        point_mlp_max,
    )
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    # 20000 points, 240 KB of cloud: more than a block's shared memory,
    # taken by the cluster variant
    pts = torch.zeros(1, 20000, 3, device=dev)
    args = (pts, torch.zeros(1, 4, dtype=torch.int32, device=dev),
            torch.ones(1, dtype=torch.int32, device=dev), 4)
    reset_launch_counts()
    ik, xk = fps(*args)
    assert launch_counts() == {"fps_cluster": 1}
    ip, xp = fps_plain(*args)
    assert torch.equal(ik, ip) and torch.equal(xk, xp)
    # 9 layers and a strided x, refused until the layer table moved to
    # device memory and the entries made their inputs contiguous
    x = torch.zeros(1, 8, 3, device=dev)
    deep = (torch.zeros(3, 4, device=dev), torch.zeros(4, device=dev)) + (
        torch.zeros(4, 4, device=dev), torch.ones(4, device=dev)) * 8
    reset_launch_counts()
    assert torch.equal(point_mlp_max(x, deep), torch.ones(1, 4, device=dev))
    assert launch_counts() == {"point_mlp_max": 1}
    strided = torch.randn(1, 3, 8, device=dev).transpose(1, 2)
    got = nn_direction(strided, x)
    want = nn_direction(strided.contiguous(), x)
    assert all(torch.equal(a, c) for a, c in zip(got, want))


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
    # widths that are no multiple of 8 (12 -> 20), N = 1 and a ragged N
    (5, 1, (3, 12, 20)),
    (3, 1000, (3, 12, 20)),
    # 128 -> 1024: pmt_bwd_dz in chunks of 128 output channels; 512 ->
    # 1024: chunks of 48, each slot's sums carried through dh_prev
    (32, 1024, (3, 64, 64, 64, 128, 1024)),
    (2, 300, (3, 64, 512, 1024)),
    # widths that are not multiples of 4, padded to them
    (3, 1000, (3, 64, 64, 64, 128, 130)),
    (5, 1, (3, 18, 130)),
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
    (32, (3, 64, 64, 64, 128, 1024)),      # chunked pmt_bwd_dz
])
def test_point_mlp_exact_backward_is_deterministic(dev, b, widths):
    rng = np.random.default_rng(7)
    x, params = _exact_args(rng, b, 1024, widths, dev)
    g = _randn(rng, b, widths[-1], dev=dev)
    _, _, first = _exact_run(x, params, g)
    _, _, second = _exact_run(x, params, g)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


def _dz_modes(x, ws, gs, bes, g, block_b):
    """(name, forward, backward(saved, oc_cap)) of the backward's three
    rounding modes: the exact chain in f32 (mode 0) and in bf16 (mode 2),
    and the ghost chain in bf16 (mode 1) with blocks of `block_b` clouds."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme
    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt

    def exact(bf16):
        return (lambda: pme.point_mlp_exact_fwd_cuda(x, ws, gs, bes, 1e-5,
                                                     bf16)[3],
                lambda saved, cap=None: pme.point_mlp_exact_bwd_cuda(
                    x, ws, gs, bes, saved, g, bf16, oc_cap=cap))

    def ghost():
        return (lambda: pmt.point_mlp_train_fwd_cuda(x, ws, gs, bes, 1e-5,
                                                     block_b, True)[3],
                lambda saved, cap=None: pmt.bwd_cuda(
                    x, ws, gs, bes, 1e-5, block_b, pmt.MODE_GHOST_BF16,
                    saved, g, pmt.KERNEL_BWD, oc_cap=cap))

    return [("mode 0", *exact(False)), ("mode 2", *exact(True)),
            (f"mode 1, blocks of {block_b}", *ghost())]


def _flat(gr):
    return [gr[0], *gr[1], *gr[2], *gr[3]]


@pytest.mark.parametrize("b,n,widths,caps,block_b", [
    (32, 1024, (3, 64, 64, 64, 128, 1024), (64, 36), 4),   # sums in registers
    (2, 300, (3, 64, 512, 1024), (16, 8), 1),              # through dh_prev
    (50, 2048, (3, 64, 128, 128, 256, 1024), (40,), 10),   # the AE encoder
    (3, 700, (3, 64, 4096), (100, 4), 1),                  # 4096 outputs
])
def test_chunked_dz_does_not_depend_on_the_chunk(dev, b, n, widths, caps,
                                                 block_b):
    """pmt_bwd_dz_chunked under its plan's chunks and under narrower ones
    (`oc_cap`, through the planner): dx, every dW, dgamma and dbeta bit
    for bit, in backward modes 0, 1 (ghost blocks) and 2; the chunked
    kernel launched once a backward."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan
    from samplenet_tpu_torch.ops.cuda._build import max_dynamic_smem
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(b + n)
    x, (ws, _, gs, bes), g = _ghost_args(rng, b, n, widths, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    limit = max_dynamic_smem(dev)
    top = plan.plan_bwd(widths, 1, b * n, sms, limit)[-1]
    assert top.dz_oc < widths[-1]
    for name, fwd, bwd in _dz_modes(x, ws, gs, bes, g, block_b):
        saved = fwd()
        reset_launch_counts()
        ref = _flat(bwd(saved))
        assert launch_counts().get("pmt_bwd_dz_chunked") == 1, name
        for cap in caps:
            assert plan.plan_bwd(widths, 1, b * n, sms, limit,
                                 cap)[-1].dz_oc == cap < top.dz_oc
            got = _flat(bwd(saved, cap))
            assert all(torch.equal(a, c) for a, c in zip(got, ref)), \
                (name, cap)


@pytest.mark.parametrize("b,n,widths,oc,block_b", [
    (50, 2048, (3, 64, 128, 128, 256, 256), 64, 10),   # K chunks of W^T
    (8, 1024, (3, 64, 256), 48, 2),                    # op(W)^T resident
    (4, 512, (3, 64, 512, 512), 64, 2),                # sums through dh_prev
    (6, 300, (3, 64, 128, 1024), 36, 3),               # chunked either way
])
def test_chunked_dz_equals_the_layouts_that_hold_dz_whole(dev, b, n, widths,
                                                          oc, block_b,
                                                          monkeypatch):
    """Where a layer fits whole, pmt_bwd_dz_chunked forced on it (chunks of
    `oc` output channels) gives the whole layouts' bits in modes 0 and 1;
    in mode 2 the whole layout is pmt_bwd_dz_mma, which sums dh_prev in K
    steps of 16 on the tensor cores, so there the forced chunks (FP32 sums
    in channel order) are held to it norm-wise within BF16_TOL: every
    gradient,
    in backward modes 0, 1 (ghost blocks) and 2; at 128 -> 1024, chunks of
    `oc` give the plan's bits."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan

    rng = np.random.default_rng(b + n + oc)
    x, (ws, _, gs, bes), g = _ghost_args(rng, b, n, widths, dev)
    whole = plan._dz_layout
    for name, fwd, bwd in _dz_modes(x, ws, gs, bes, g, block_b):
        saved = fwd()
        ref = _flat(bwd(saved))
        monkeypatch.setattr(plan, "_dz_layout", lambda cin_pad, cout, limit,
                            cap=None, bf16=False, top=False: (oc, False, oc)
                            if cout > oc
                            else whole(cin_pad, cout, limit, cap, bf16, top))
        got = _flat(bwd(saved))
        monkeypatch.setattr(plan, "_dz_layout", whole)
        if not name.startswith("mode 2"):
            assert all(torch.equal(a, c) for a, c in zip(ref, got)), name
        else:
            gap = max(_norm_err(a, c) for a, c in zip(got, ref))
            assert gap <= BF16_TOL, (name, gap)


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


def _soft_fwd_inputs(kind, b, n, m, seed, dev):
    """randn clouds and queries; "nan": some points and some queries with a
    NaN coordinate; "triples": every point of an integer grid three times,
    queries on grid points and cell centres (exact ties); "cluster": the
    first 512 points next to the first query, which puts more candidates
    through the kernel's second pass than a lane's buffer holds."""
    rng = np.random.default_rng(seed)
    pts = rng.standard_normal((b, n, 3)).astype(np.float32)
    qs = rng.standard_normal((b, m, 3)).astype(np.float32)
    if kind == "nan":
        pts[:, rng.choice(n, size=max(1, n // 8), replace=False), 1] = np.nan
        qs[:, rng.choice(m, size=max(1, m // 5), replace=False), 2] = np.nan
    elif kind == "triples":
        grid = rng.integers(-3, 4, size=(b, -(-n // 3), 3))
        pts = np.repeat(grid, 3, axis=1)[:, :n].astype(np.float32)
        qs = (rng.integers(-3, 4, size=(b, m, 3))
              + 0.5 * rng.integers(0, 2, size=(b, m, 1))).astype(np.float32)
    elif kind == "cluster":
        pts[:, :512] = qs[:, :1] + 1e-3 * pts[:, :512]
    return (torch.from_numpy(np.ascontiguousarray(pts)).to(dev),
            torch.from_numpy(qs).to(dev), torch.tensor([0.4], device=dev))


def _soft_fwd_check(pts, qs, sigma, k, ok, ik):
    """idx bit-equal to the plain version's stable sort, out within atol
    1e-5 (NaN where the plain version's is); a NaN query takes 0..k-1."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    op, ip = spk.soft_project_fwd_plain(pts, qs, sigma, k)
    assert torch.equal(ik, ip), f"idx differ in {int((ik != ip).sum())} places"
    torch.testing.assert_close(ok, op, rtol=0, atol=1e-5, equal_nan=True)
    nan_q = torch.isnan(qs).any(-1)
    if nan_q.any():
        assert bool((ik[nan_q] == torch.arange(k, device=ik.device)).all())


@pytest.mark.parametrize("kind,b,n,m,k", [
    ("nan", 3, 200, 40, 7),          # NaN points and NaN queries
    ("nan", 2, 1000, 33, 16),
    ("nan", 2, 40, 9, 1),
    ("triples", 3, 300, 50, 16),     # ties to the lowest index
    ("triples", 2, 96, 17, 7),
    ("triples", 2, 31, 8, 1),
    ("randn", 4, 20, 11, 16),        # n < 32
    ("randn", 3, 1000, 33, 7),       # n not a multiple of 32
    ("randn", 2, 5000, 40, 16),      # n longer than one staged chunk
    ("randn", 5, 512, 77, 7),        # M not a multiple of a block's queries
    ("cluster", 2, 2048, 40, 16),    # the candidate buffer fills
    ("cluster", 3, 1000, 70, 7),
    ("randn", 50, 2048, 2048, 16),   # the progressive AE step's shape
    ("randn", 32, 1024, 64, 8),      # the registration sampler's, k = 8
])
def test_soft_projection_forward_edge_cases(dev, kind, b, n, m, k):
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    pts, qs, sigma = _soft_fwd_inputs(kind, b, n, m, b * n + m + k, dev)
    ok, ik = spk.soft_project_fwd_cuda(pts, qs, sigma, k)
    torch.cuda.synchronize()
    _soft_fwd_check(pts, qs, sigma, k, ok, ik)


@pytest.mark.parametrize("kind,b,n,m,k", [("randn", 3, 300, 70, 7),
                                          ("nan", 2, 1000, 50, 16),
                                          ("cluster", 2, 1000, 50, 16)])
def test_soft_projection_forward_under_other_plans(dev, kind, b, n, m, k):
    """The outputs do not depend on the launch plan: several chunks, other
    block widths and lanes a query, and a ragged last block give the
    planned launch's bits."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda.soft_projection_plan import FwdPlan

    pts, qs, sigma = _soft_fwd_inputs(kind, b, n, m, 7 + k, dev)
    ok, ik = spk.soft_project_fwd_cuda(pts, qs, sigma, k)
    _soft_fwd_check(pts, qs, sigma, k, ok, ik)
    for chunk in (32, 64, 1024):
        for warps, slices in ((1, 1), (3, 2), (2, 8), (8, 4)):
            o, i = spk.launch_fwd(pts, qs, sigma, k,
                                  FwdPlan(chunk, warps, slices, (b, 0)))
            torch.cuda.synchronize()
            assert torch.equal(i, ik), (chunk, warps, slices)
            assert torch.equal(o.nan_to_num(7.0), ok.nan_to_num(7.0)), (
                chunk, warps, slices)


def _soft_bwd_inputs(kind, b, n, m, k, seed, dev):
    """randn clouds, queries and cotangent, sigma^2 = 0.6, and idx: "knn",
    the forward's neighbours; "one", every entry on point 3; "same", every
    query on the same k points; "zero", the forward's with a zero
    cotangent."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    rng = np.random.default_rng(seed)
    pts, qs, cot = (_randn(rng, b, c, 3, dev=dev) for c in (n, m, m))
    sigma = torch.tensor([0.6], device=dev)
    if kind == "one":
        idx = torch.full((b, m, k), 3, dtype=torch.int32, device=dev)
    elif kind == "same":
        pick = torch.from_numpy(rng.choice(n, size=k, replace=False))
        idx = pick.to(torch.int32).to(dev).expand(b, m, k).contiguous()
    else:
        idx = spk.soft_project_fwd_cuda(pts, qs, sigma, k)[1]
    if kind == "zero":
        cot.zero_()
    return pts, qs, sigma, idx, cot


SOFT_BWD_CASES = [
    ("one", 2, 50, 4096, 1),       # one point takes all M*k entries
    ("same", 2, 50, 2048, 16),     # 16 points take 2048 entries each
    ("knn", 2, 16384, 64, 16),     # N = 16384: no cap on N
    ("knn", 3, 1000, 33, 1),       # ragged B, N and M
    ("knn", 3, 1000, 33, 16),
    ("knn", 5, 77, 300, 16),
    ("knn", 7, 300, 333, 1),
    ("zero", 3, 1000, 70, 7),      # a zero cotangent
    ("knn", 1, 1, 5, 1),           # N = 1
    ("knn", 2, 16, 5, 16),         # k = N
    ("knn", 50, 2048, 2048, 16),   # the progressive AE step's shape
    ("knn", 65536, 8, 2, 2),       # B above a 16-bit grid dimension
    ("knn", 32, 1024, 64, 8),      # the registration sampler's, k = 8
]


@pytest.mark.parametrize("kind,b,n,m,k", SOFT_BWD_CASES)
def test_soft_projection_backward_edge_cases(dev, kind, b, n, m, k):
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    args = _soft_bwd_inputs(kind, b, n, m, k, b + n + m + k, dev)
    got = spk.soft_project_bwd_cuda(*args)
    torch.cuda.synchronize()
    want = spk.soft_project_bwd_plain(*args)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
    if kind == "zero":
        assert not any(t.any() for t in got)


@pytest.mark.parametrize("kind,b,n,m,k", [SOFT_BWD_CASES[i]
                                          for i in (0, 1, 2, 4, 6, 10, 11,
                                                    12)])
def test_soft_projection_backward_under_other_plans(dev, kind, b, n, m, k):
    """The bits do not depend on the launch plan (query tile, threads and
    points a block), nor on the run."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda.soft_projection_plan import BwdPlan

    args = _soft_bwd_inputs(kind, b, n, m, k, 3 * n + k, dev)
    want = spk.soft_project_bwd_cuda(*args)
    plan = spk.bwd_plan(args[0].device.index, b, n, m, k)
    others = [BwdPlan(32, 32, 32), BwdPlan(64, 32, 128),
              BwdPlan(128, 128, 512), BwdPlan(256, 256, 1024),
              BwdPlan(256, 256, 256), BwdPlan(256, 64, 256, count64=True)]
    assert sum(o != plan for o in others) >= 3
    for other in others:
        got = spk.launch_bwd(*args, other)
        torch.cuda.synchronize()
        assert all(torch.equal(a, c) for a, c in zip(got, want)), other
    again = spk.soft_project_bwd_cuda(*args)
    assert all(torch.equal(a, c) for a, c in zip(again, want))


def test_soft_projection_backward_at_n_16384_through_autograd(dev):
    """soft_project and .backward() on 16384-point clouds, k = 16, against
    the plain path."""
    rng = np.random.default_rng(16384)
    pts, qs, cot = (_randn(rng, 2, c, 3, dev=dev) for c in (16384, 64, 64))
    sigma = torch.tensor(0.5, device=dev)
    ok, ik, gk = _soft_run(pts, qs, sigma, 16, cot)
    op, ip, gp = _soft_run(pts, qs, sigma, 16, cot, plain=True)
    assert torch.equal(ik, ip)
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5)
    for a, c in zip(gk, gp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


def test_soft_projection_backward_refuses_a_plan_the_kernel_disagrees_with(
        dev, monkeypatch):
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp

    args = _soft_bwd_inputs("knn", 2, 300, 40, 7, 5, dev)
    # the plan's limits or shared memory off the kernel's: the wrapper
    # raises before it launches
    for name, value in (("UNROLL", 2 * spp.UNROLL), ("MAX_PER", 8),
                        ("STRIPES", 128)):
        with monkeypatch.context() as mp:
            mp.setattr(spp, name, value)
            spk.bwd_plan.cache_clear()
            with pytest.raises(RuntimeError, match="disagree"):
                spk.soft_project_bwd_cuda(*args)
    spk.bwd_plan.cache_clear()
    # a plan the kernel's C entry refuses: tile or threads not a multiple
    # of 32, fewer points than threads, more than four points a thread
    for bad in (spp.BwdPlan(48, 32, 32), spp.BwdPlan(32, 48, 96),
                spp.BwdPlan(32, 64, 32), spp.BwdPlan(32, 32, 256),
                spp.BwdPlan(32, 512, 512)):
        with pytest.raises(RuntimeError, match="soft_projection_bwd"):
            spk.launch_bwd(*args, bad)
    spk.soft_project_bwd_cuda(*args)


# ------------------------------------------------ group sizes above 16

# (B, N, M, k): k = 17..1024 at B=4, N=1024, M=64, the classification
# step's shape at k = 32 and the reconstruction sampler's at 32,768 points
WIDE_SHAPES = [(4, 1024, 64, k) for k in (17, 24, 32, 64, 256, 1024)] + [
    (1024, 1024, 32, 32), (4, 32768, 64, 32)]


@pytest.mark.parametrize("b,n,m,k", WIDE_SHAPES)
def test_soft_projection_wide_k_matches_plain(dev, b, n, m, k):
    """soft_project and .backward() on the wide kernels against the plain
    path: idx bit-equal, out and the gradients by the k <= 16 rules."""
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(b + k)
    pts, qs, cot = (_randn(rng, b, c, 3, dev=dev) for c in (n, m, m))
    sigma = torch.tensor(0.5, device=dev)
    reset_launch_counts()
    ok, ik, gk = _soft_run(pts, qs, sigma, k, cot)
    torch.cuda.synchronize()
    assert launch_counts() == {"soft_projection_fwd_wide": 1,
                               "soft_projection_bwd_wide": 1}
    op, ip, gp = _soft_run(pts, qs, sigma, k, cot, plain=True)
    assert torch.equal(ik, ip)
    torch.testing.assert_close(ok, op, rtol=1e-5, atol=1e-5)
    for a, c in zip(gk, gp):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("kind,b,n,m,k", [
    ("nan", 3, 200, 40, 17),         # NaN points and NaN queries
    ("nan", 2, 40, 9, 40),           # k = N
    ("triples", 3, 300, 50, 33),     # ties to the lowest index
    ("triples", 2, 96, 17, 96),
    ("randn", 4, 20, 11, 20),        # n < 32
    ("randn", 2, 5000, 40, 100),     # n longer than the k <= 16 chunk
    ("cluster", 2, 2048, 40, 600),   # 512 points next to the first query
    ("randn", 5, 1000, 77, 17),      # a ragged last block of queries
])
def test_soft_projection_wide_forward_edge_cases(dev, kind, b, n, m, k):
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    pts, qs, sigma = _soft_fwd_inputs(kind, b, n, m, b * n + m + k, dev)
    ok, ik = spk.soft_project_fwd_cuda(pts, qs, sigma, k)
    torch.cuda.synchronize()
    _soft_fwd_check(pts, qs, sigma, k, ok, ik)


@pytest.mark.parametrize("kind,k", [("randn", 1), ("nan", 7), ("triples", 16),
                                    ("cluster", 16)])
def test_soft_projection_wide_forward_at_small_k(dev, kind, k):
    """The wide kernel takes every k (the wrapper sends it k > 16 only):
    at k <= 16 its idx equal the register kernel's and the plain
    version's."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp

    b, n, m = 3, 1000, 70
    pts, qs, sigma = _soft_fwd_inputs(kind, b, n, m, k, dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for plan in (spp.plan_fwd_wide(b, n, m, k, sms=sms),
                 spp.WideFwdPlan(0, 1, 0, 0, 0, 0, -(-b * m // 8))):
        ow, iw = spk.launch_fwd_wide(pts, qs, sigma, k, plan)
        torch.cuda.synchronize()
        _soft_fwd_check(pts, qs, sigma, k, ow, iw)
        assert torch.equal(iw, spk.soft_project_fwd_cuda(pts, qs, sigma,
                                                         k)[1])


WIDE_BWD_CASES = [
    ("one", 2, 50, 300, 17),       # one point takes all M*k entries
    ("same", 2, 50, 200, 32),      # 32 points take 200 entries each
    ("knn", 3, 1000, 33, 17),      # ragged B, N and M
    ("knn", 2, 16384, 64, 64),     # a long cloud
    ("knn", 5, 77, 300, 77),       # k = N
    ("zero", 3, 1000, 70, 24),     # a zero cotangent
    ("knn", 4, 1024, 64, 256),
    ("knn", 150, 1024, 32, 32),    # the fused kernel: a block a cloud
    ("knn", 140, 300, 40, 100),    # fused, a warp a query
]


@pytest.mark.parametrize("kind,b,n,m,k", WIDE_BWD_CASES)
def test_soft_projection_wide_backward_edge_cases(dev, kind, b, n, m, k):
    """Against the plain version, and bit for bit under other launch plans
    and from run to run."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp
    from samplenet_tpu_torch.ops.cuda.soft_projection_plan import WideBwdPlan

    args = _soft_bwd_inputs(kind, b, n, m, k, b + n + m + k, dev)
    got = spk.soft_project_bwd_cuda(*args)
    torch.cuda.synchronize()
    want = spk.soft_project_bwd_plain(*args)
    for a, c in zip(got, want):
        torch.testing.assert_close(a, c, rtol=1e-4, atol=1e-5)
    if kind == "zero":
        assert not any(t.any() for t in got)
    plan = spk.bwd_plan(args[0].device.index, b, n, m, k)
    others = [WideBwdPlan(1, 32, 1), WideBwdPlan(8, 32, 32),
              WideBwdPlan(2, 128, 100), WideBwdPlan(4, 256, 1024),
              WideBwdPlan(8, 1024, 4096), WideBwdPlan(1, 64, 77)]
    # the fused kernel where a block holds the cloud (the plan's at B=150)
    others += [WideBwdPlan(8, t, 32, fused=True) for t in (256, 128, 64)
               if m * k <= spp.FUSED_ENTRIES and n <= 4 * t]
    assert sum(o != plan for o in others) >= 5
    for other in others:
        again = spk.launch_bwd(*args, other)
        assert all(torch.equal(a, c) for a, c in zip(again, got)), other
    again = spk.soft_project_bwd_cuda(*args)
    assert all(torch.equal(a, c) for a, c in zip(again, got))


def test_soft_projection_wide_backward_refuses_a_plan_it_does_not_take(
        dev, monkeypatch):
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp

    args = _soft_bwd_inputs("knn", 2, 300, 40, 20, 5, dev)
    # the plan's limits or shared memory off the kernel's: the wrapper
    # raises before it launches
    for name, value in (("WINDOW_PER", 2 * spp.WINDOW_PER),
                        ("WIDE_SPAN", 8192), ("WIDE_RANKS", 4),
                        ("WIDE_POINTS_PER", 8), ("FUSED_ENTRIES", 2048)):
        with monkeypatch.context() as mp:
            mp.setattr(spp, name, value)
            spk.bwd_plan.cache_clear()
            with pytest.raises(RuntimeError, match="disagree"):
                spk.soft_project_bwd_cuda(*args)
    spk.bwd_plan.cache_clear()
    # a plan the C entry refuses: no warps or more than 8, threads not a
    # multiple of 32 or past 1024, no points, more than 4096 a block or
    # more than 4 a thread
    # a fused kernel of more than 256 threads, of more than 4 points a
    # thread, or of more entries than FUSED_ENTRIES
    for bad in (spp.WideBwdPlan(0, 256, 64), spp.WideBwdPlan(9, 256, 64),
                spp.WideBwdPlan(8, 48, 64), spp.WideBwdPlan(8, 2048, 64),
                spp.WideBwdPlan(8, 256, 0), spp.WideBwdPlan(8, 1024, 8192),
                spp.WideBwdPlan(8, 64, 257),
                spp.WideBwdPlan(8, 512, 64, fused=True),
                spp.WideBwdPlan(8, 64, 64, fused=True)):
        with pytest.raises(RuntimeError, match="soft_projection_bwd_wide"):
            spk.launch_bwd(*args, bad)
    spk.soft_project_bwd_cuda(*args)


def test_soft_projection_more_queries_than_the_register_grid(dev):
    """16,777,000 queries of one cloud, k = 4: past the register forward's
    grid axis, the wide forward takes them."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(5)
    pts, qs = _randn(rng, 1, 16, 3, dev=dev), _randn(rng, 1, 16777000, 3,
                                                     dev=dev)
    sigma = torch.tensor([0.5], device=dev)
    reset_launch_counts()
    ok, ik = spk.soft_project_fwd_cuda(pts, qs, sigma, 4)
    torch.cuda.synchronize()
    assert launch_counts() == {"soft_projection_fwd_wide": 1}
    _soft_fwd_check(pts, qs, sigma, 4, ok, ik)


def test_soft_projection_small_k_keeps_the_register_kernels(dev):
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(0)
    pts, qs, cot = (_randn(rng, 2, c, 3, dev=dev) for c in (300, 40, 40))
    for k in (1, 7, 8, 16):
        reset_launch_counts()
        _soft_run(pts, qs, torch.tensor(0.5, device=dev), k, cot)
        assert launch_counts() == {spk.KERNEL_FWD: 1, spk.KERNEL_BWD: 1}
    assert spk.fwd_plan(0, 1024, 1024, 32) == spk.spp.plan_fwd(
        1024, 1024, 32, sms=torch.cuda.get_device_properties(0)
        .multi_processor_count)


# ------------------------------------------------ FPS beyond one block

@pytest.mark.parametrize("b,n,k,counts", [
    (2, 16385, 64, "random"), (4, 16385, 1024, "random"),
    (2, 32768, 64, "random"), (3, 32768, 1024, "random"),
    (2, 100003, 64, "random"), (2, 100003, 1024, "random"),
    (2, 8192, 8192, "random"),       # k = N: the picks beyond shared memory
    (1, 2**20, 256, "one"),          # streamed running distances
    (2, 17600, 1024, "all"),
])
def test_fps_cluster_bit_equal(dev, b, n, k, counts):
    from samplenet_tpu_torch.ops.cuda import fps_kernel
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(n + k)
    pts = _randn(rng, b, n, 3, dev=dev)
    given, count = _fps_given(rng, b, n, k, counts, dev)
    plan = fps_kernel.kernel_plan(0, b, n, k)
    assert plan.cluster and plan.stream == (n > 131072)
    reset_launch_counts()
    _fps_check(pts, given, count, k)
    assert launch_counts() == {"fps_cluster": 1}


def _cluster_plans(n):
    """Every cluster build's plan that holds a cloud of n points: each C
    with each R that holds it, and the streamed build."""
    from samplenet_tpu_torch.ops.cuda import fps_plan

    plans = [fps_plan.FpsPlan(32, r, False, c)
             for c in fps_plan.CLUSTER_SIZES for r in fps_plan.CLUSTER_POINTS]
    plans.append(fps_plan.FpsPlan(32, 0, False, fps_plan.STREAM_CLUSTER))
    return [p for p in plans if fps_plan.valid(p, n)]


@pytest.mark.parametrize("kind", ["nan_picked", "nan_given", "all_nan",
                                  "grid"])
def test_fps_cluster_on_nan_clouds_and_ties(dev, kind):
    """Under the plan and under every C that holds the cloud (its fewest
    R) and streamed: idx and xyz bit for bit."""
    from samplenet_tpu_torch.ops.cuda import fps_plan

    b, n, k = 3, 20000, 64
    rng = np.random.default_rng(len(kind))
    pts = _randn(rng, b, n, 3, dev=dev)
    given, count = _fps_given(rng, b, n, k, "random", dev)
    if kind == "nan_picked":
        pts[:, 17000, 1] = float("nan")
    elif kind == "nan_given":
        pts[:, 5, 2] = float("nan")
        given[:, 0] = 5
    elif kind == "all_nan":
        pts[1] = float("nan")
    else:
        g = torch.arange(28, dtype=torch.float32, device=dev)
        grid = torch.stack(torch.meshgrid(g, g, g, indexing="ij"), -1)
        pts = grid.reshape(1, -1, 3)[:, :n].repeat(b, 1, 1).contiguous()
    pts = pts.contiguous()
    ik = _fps_check(pts, given, count, k)
    if kind == "all_nan":
        assert not ik[1, int(count[1]):].any()
    plans = fps_plan.cluster_candidates(n, smem_limit=232448)
    assert [p.cluster for p in plans] == [2, 4, 8]
    for plan in plans + [fps_plan.FpsPlan(32, 0, False,
                                          fps_plan.STREAM_CLUSTER)]:
        _fps_check(pts, given, count, k, plan)


@pytest.mark.parametrize("n", [20000, 5000, 8192])
def test_fps_cluster_under_every_plan(dev, n):
    """The outputs do not depend on C, R or streaming, nor on the run."""
    b, k = 2, 300
    rng = np.random.default_rng(n)
    pts = _randn(rng, b, n, 3, dev=dev)
    pts[0, n // 2, 1] = float("nan")
    given, count = _fps_given(rng, b, n, k, "random", dev)
    plans = _cluster_plans(n)
    assert len(plans) >= 7 and {p.cluster for p in plans} >= {2, 4, 8}
    if n <= 16384:
        assert any(p.cluster == 1 for p in plans)
    for plan in plans:
        _fps_check(pts, given, count, k, plan)


def test_fps_todays_shapes_keep_the_block_kernel(dev):
    from samplenet_tpu_torch.ops.cuda import fps_kernel
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(1)
    for b, n, k in ((1024, 1024, 32), (50, 2048, 64), (3, 5000, 64),
                    (1, 16384, 8), (1, 7000, 7000)):
        pts = _randn(rng, b, n, 3, dev=dev)
        given, count = _fps_given(rng, b, n, k, "random", dev)
        assert not fps_kernel.kernel_plan(0, b, n, k).cluster
        reset_launch_counts()
        _fps_check(pts, given, count, k)
        assert launch_counts() == {"fps": 1}


@pytest.mark.parametrize("n", [1000, 20000])
def test_fps_takes_a_strided_cloud(dev, n):
    from samplenet_tpu_torch.ops.fps import farthest_point_sample_with_points

    rng = np.random.default_rng(n)
    cm = _randn(rng, 2, 3, n, dev=dev)             # channel-major storage
    got = farthest_point_sample_with_points(64, cm.transpose(1, 2))
    want = farthest_point_sample_with_points(
        64, cm.transpose(1, 2).contiguous())
    assert all(torch.equal(a, c) for a, c in zip(got, want))


def test_fps_cluster_refuses_a_plan_it_does_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import fps_kernel, fps_plan

    pts = torch.zeros(1, 9000, 3, device=dev)
    given, count = _fps_given(np.random.default_rng(0), 1, 9000, 8, "one",
                              dev)
    for bad in (fps_plan.FpsPlan(32, 1, False, 8),   # holds 8192 points
                fps_plan.FpsPlan(32, 3, False, 8),   # R = 3
                fps_plan.FpsPlan(32, 32, False, 8)):  # R above 16
        with pytest.raises(RuntimeError, match="fps_cluster"):
            fps_kernel.launch(pts, given, count, 8, bad)


@pytest.mark.parametrize("c,r", [(3, 4), (16, 1), (6, 2), (1, 0), (2, 0),
                                 (8, 0), (32, 0)])
def test_fps_cluster_refuses_a_cluster_size_the_build_lacks(dev, c, r):
    """C outside {1, 2, 4, 8} (and streaming but at C = 16): the plan
    does not take it, the library has no occupancy for it, and the launch
    raises."""
    from samplenet_tpu_torch.ops.cuda import fps_kernel, fps_plan
    from samplenet_tpu_torch.ops.cuda._build import library

    plan = fps_plan.FpsPlan(32, r, False, c)
    assert not fps_plan.valid(plan, 9000)
    assert library().snt_fps_cluster_active(c, r) == -1
    assert all(v >= 1 for v in fps_kernel.cluster_active(0).values())
    pts = torch.zeros(1, 9000, 3, device=dev)
    given, count = _fps_given(np.random.default_rng(0), 1, 9000, 8, "one",
                              dev)
    with pytest.raises(RuntimeError, match="fps_cluster"):
        fps_kernel.launch(pts, given, count, 8, plan)


def test_train_kernels_refuse_what_they_do_not_take(dev):
    from samplenet_tpu_torch.ops.cuda import (
        point_mlp_exact_train_max,
        soft_project,
    )
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    # k = 17 is taken: the wide kernel, not a refusal
    pts = torch.zeros(1, 40, 3, device=dev)
    reset_launch_counts()
    _, idx = soft_project(pts, pts[:, :4].contiguous(),
                          torch.tensor(1.0, device=dev), 17)
    assert idx.shape == (1, 4, 17)
    assert launch_counts() == {"soft_projection_fwd_wide": 1}
    w = torch.zeros(3, 6, device=dev, dtype=torch.float64)
    v = torch.zeros(6, device=dev, dtype=torch.float64)
    with pytest.raises(TypeError, match="float32"):
        point_mlp_exact_train_max(pts.double(), [w], [v], [v], [v])


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


# the steep levels, where most weights underflow to +0
STEEP_LEVELS = (-65536.0, -16384.0, -4096.0, -1024.0, -256.0)


def _emd_inputs(kind, b, n, m, dev):
    """(xyz1, xyz2) of one kind: "randn", standard-normal clouds;
    "straddle", xyz2_i at distance sqrt(104 / |L|) * (1 -+ 1e-3) from
    xyz1_i, L cycling over the steep levels, so level * d2 lies just above
    and just below the kernel's underflow constant; "coincident", randn
    with every 7th row and every 5th column at the origin (d2 = 0, at the
    one place where x1 * sum u - sum u x2 has no round-off to amplify);
    "clustered", 8 tight clusters 6 apart, each a run of consecutive
    points, so whole warps' units underflow at most levels."""
    rng = np.random.default_rng(b * 10000 + n + m)
    if kind == "randn":
        return _randn(rng, b, n, 3, dev=dev), _randn(rng, b, m, 3, dev=dev)
    if kind == "straddle":
        x1 = 4.0 * rng.standard_normal((b, n, 3))
        way = rng.standard_normal((b, n, 3))
        way /= np.linalg.norm(way, axis=2, keepdims=True)
        i = np.arange(n)
        level = np.asarray(STEEP_LEVELS)[i % len(STEEP_LEVELS)]
        side = np.where((i // len(STEEP_LEVELS)) % 2 == 0, 1 - 1e-3, 1 + 1e-3)
        r = np.sqrt(104.0 / -level) * side
        x2 = (x1 + r[None, :, None] * way)[:, :m]
        return (torch.from_numpy(x1.astype(np.float32)).to(dev),
                torch.from_numpy(x2.astype(np.float32)).to(dev))
    if kind == "coincident":
        x1, x2 = _randn(rng, b, n, 3, dev=dev), _randn(rng, b, m, 3, dev=dev)
        x1[:, ::7] = 0.0
        x2[:, ::5] = 0.0
        return x1, x2
    assert kind == "clustered"
    centres = 6.0 * rng.standard_normal((b, 8, 3))
    clouds = []
    for size in (n, m):
        which = np.arange(size) * 8 // size
        pts = centres[:, which] + 0.05 * rng.standard_normal((b, size, 3))
        clouds.append(torch.from_numpy(pts.astype(np.float32)).to(dev))
    return tuple(clouds)


@pytest.mark.parametrize("kind,b,n,m", [
    ("randn", 3, 96, 160),     # ragged row tile, factorr 1 / factorl 1
    ("randn", 2, 128, 64),     # n = 2m: factorl 1, factorr 2
    ("randn", 2, 64, 192),     # m = 3n: factorl 3
    ("randn", 1, 1000, 1000),  # B=1, ragged
    ("randn", 3, 2048, 64),
    ("randn", 2, 100, 70),     # n, m not multiples of 32
    ("randn", 1, 300, 2500),   # m past the register cache: the shared slab
    ("straddle", 2, 320, 320),
    ("coincident", 2, 203, 301),
    ("clustered", 2, 512, 512),
    ("clustered", 1, 1000, 2100),
])
def test_emd_matches_plain_and_f64(dev, kind, b, n, m):
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
    is bit-equal from run to run. The inputs (`_emd_inputs`) reach the
    kernel's skip of warp units whose weights underflow: pairs on either
    side of its threshold at each steep level, d2 = 0, clusters whose
    units underflow whole, and ragged and wide clouds."""
    from samplenet_tpu_torch.ops.cuda import emd_cost, emd_cost_plain

    x1, x2 = _emd_inputs(kind, b, n, m, dev)
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
    print(f"\nemd {kind} ({b}, {n}, {m}) over 4 inputs, g1 then g2, (largest "
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


def test_emd_expf_underflows_below_the_skip_threshold(dev):
    """The kernel skips a warp's unit when every level * d2 in it lies
    below its constant, as adding exact zeros: the card's expf, called as
    the kernel calls it, must give +0 for every f32 from that constant
    down to -inf (about 1e9 values, one launch)."""
    from samplenet_tpu_torch.ops.cuda.emd_kernel import (
        expf_underflow_violations,
    )

    under, bad = expf_underflow_violations(dev)
    assert under <= -103.972, under   # ln of half the least subnormal
    assert bad == 0, (under, bad)


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


def test_registration_sampler_step_kernel_path_matches_plain_path(dev):
    """One registration sampler step at full width (B=32 pairs of 1024
    points, m=64, k=8, both clouds sampled) against a seeded frozen PCRNet,
    on the kernel path and on the plain path from the same state: each
    kernel launched as often as the step runs it, the loss terms within
    rtol 1e-4 of the plain path; each path's discrete choices (the 1-NN
    indices, the soft projection's neighbours, PCRNet's ReLU masks and
    max-pool argmaxes) replayed by a float64 plain step (chip_smoke.py's
    `choices`), and every gradient's norm-wise
    error against its own replay at most twice the plain path's (or 1e-4
    of its norm); the gradients zero in exact arithmetic (the dense biases
    before BN, the last conv BN's beta) round-off. Without the replay a
    choice that moves on a near-tie, apart on the two f32 paths, sets
    each path's error against f64 (tools/diagnostics/
    registration_choices.py prints which choices move, and the errors
    with and without the replay)."""
    import copy

    from chip_smoke import choices
    from samplenet_tpu_torch.geometry import QuaternionTransform
    from samplenet_tpu_torch.models import PCRNet
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.train import registration as reg

    cfg = reg.RegistrationConfig()
    rng = np.random.default_rng(15)
    p0 = 0.5 * _randn(rng, 32, 1024, 3, dev=dev)
    q = _randn(rng, 32, 4, dev=dev)
    tw = torch.cat([q / q.norm(dim=-1, keepdim=True),
                    torch.zeros(32, 3, device=dev)], -1)
    p1 = QuaternionTransform(tw).rotate(p0)
    pcrnet = PCRNet(generator=torch.Generator().manual_seed(2)).to(dev)

    def run(dtype, plain, how):
        sampler, state = reg.create_sampler_state(cfg, device=dev, seed=1)
        sampler.to(dtype)
        step = reg.make_sampler_train_step(
            sampler, copy.deepcopy(pcrnet).to(dtype), cfg)
        reset_launch_counts()
        with plain_on_cuda() if plain else contextlib.nullcontext(), how:
            m = step(state, *(t.to(dtype) for t in (p0, p1, tw)))
            torch.cuda.synchronize()
        return m, launch_counts(), {k: p.grad.clone() for k, p in
                                    sampler.named_parameters()}

    runs = []
    for plain in (False, True):
        made = []
        runs.append((*run(torch.float32, plain, choices(torch, record=made)),
                     run(torch.float64, True, choices(torch, replay=made))[2]))
    (mk, ck, gk, gkr), (mp, cp, gp, gpr) = runs
    assert cp == {}
    for name in ("point_mlp_exact_fwd", "point_mlp_exact_bwd",
                 "soft_projection_fwd", "soft_projection_bwd"):
        assert ck.get(name) == 2, ck
    assert ck.get("nn_direction") == 6, ck
    for k in mk:
        assert bool(torch.isfinite(mk[k])), k
        torch.testing.assert_close(mk[k], mp[k], rtol=1e-4, atol=0)
    scale = max(float(g.abs().max()) for g in gkr.values())
    cancelled = {f"conv{i}.bias" for i in range(1, 6)} | {
        "bn5.bias", "fc1.bias", "fc2.bias", "fc3.bias"}
    for name in gk:
        if name in cancelled:
            assert float(gk[name].abs().max()) <= 1e-4 * scale, name
            assert float(gp[name].abs().max()) <= 1e-4 * scale, name
            continue
        ek = _norm_err(gk[name], gkr[name])
        ep = _norm_err(gp[name], gpr[name])
        assert ek <= max(2 * ep, 1e-4), (name, ek, ep)


# ------------------------------------------------ nn_snap and the ghost chain

@pytest.mark.parametrize("b,n1,n2", [
    (1, 1, 1),
    (2, 1, 5000),       # N2 > kMaxChunk: three staged chunks, one query
    (3, 1000, 2500),    # N1 not a multiple of the query tile, N2 > kMaxChunk
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
    database point in cloud 1 (a NaN distance to every query: dist NaN,
    index 5) and NaN queries (dist NaN, index 0)."""
    from samplenet_tpu_torch.ops.cuda import nn_snap, nn_snap_plain

    rng = np.random.default_rng(11)
    base = _randn(rng, 2, 700, 3, dev=dev)
    y = torch.cat([base, base, base], dim=1).contiguous()
    y[1, 5] = float("nan")
    x = torch.cat([base[:, ::7], torch.full((2, 3, 3), float("nan"),
                                            device=dev)], 1).contiguous()
    dk, ik, sk = nn_snap(x, y)
    dp, ip, sp = nn_snap_plain(x, y)
    assert _same_or_nan(dk, dp) and torch.equal(ik, ip)
    assert _same_bits(sk, sp)
    assert int(ik[0, :-3].max()) < 700 and float(dk[0, :-3].max()) == 0.0
    assert (ik[1, :-3] == 5).all() and torch.isnan(dk[1]).all()
    assert not ik[:, -3:].any() and torch.isnan(dk[:, -3:]).all()


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

    widths = [x.shape[-1], *(w.shape[1] for w in params[0])]
    if any(c % 4 for c in widths[1:]):     # the kernels run padded widths
        params = pmt.pad_params(widths, *params)
        g = torch.nn.functional.pad(g, (0, params[0][-1].shape[1]
                                        - g.shape[1]))
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


@pytest.mark.parametrize("b,n,bb,bf16", [
    (4, 1000, 2, True),
    (4, 1000, 2, False),
    (8, 1, 4, True),
    (8, 1, 4, False),
])
def test_point_mlp_train_at_widths_off_the_k_step(dev, b, n, bb, bf16):
    """3 -> 12 -> 20: widths that are no multiple of 8, at N = 1 and a
    ragged N, in bf16 and in f32."""
    rng = np.random.default_rng(b * 1000 + n + bf16)
    x, params, g = _ghost_args(rng, b, n, (3, 12, 20), dev)
    _ghost_check(x, params, g, bb, bf16)


@pytest.mark.parametrize("widths,b,n,bb,bf16", [
    ((3, 64, 64, 64, 128, 130), 8, 256, 4, True),     # padded to 132
    ((3, 20, 36, 130), 4, 1000, 2, True),             # off the K step of 16
    ((3, 64, 64, 64, 128, 130), 8, 256, 4, False),
    ((3, 18, 130), 4, 1000, 2, True),
    ((3, 64, 64, 64, 128, 1024), 8, 256, 2, False),   # chunked pmt_bwd_dz
])
def test_point_mlp_train_at_odd_and_wide_widths(dev, widths, b, n, bb,
                                                bf16):
    rng = np.random.default_rng(b * 1000 + n + widths[-1] + bf16)
    x, params, g = _ghost_args(rng, b, n, widths, dev)
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
    with pytest.raises(ValueError, match="no valid batch block"):
        point_mlp_train_max(pts, [w], [v], [v], [v], block_b=3)


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


def test_tnet_classifier_forward_matches_the_cpu(dev):
    """The T-net PointNetClassifier at its published widths, seeded on the
    CPU (T-net transforms moved off zero) and moved to the card: logits
    within rtol 1e-4 (atol 1e-5 of scale) of the CPU forward."""
    from samplenet_tpu_torch.models import PointNetClassifier

    cpu = PointNetClassifier(40, use_tnets=True,
                             generator=torch.Generator().manual_seed(3))
    gen = torch.Generator().manual_seed(4)
    with torch.no_grad():
        for tnet in (cpu.tnet_input, cpu.tnet_feature):
            tnet.transform.weight.copy_(
                0.002 * torch.randn(tnet.transform.weight.shape,
                                    generator=gen))
    x = torch.from_numpy(np.random.default_rng(6).standard_normal(
        (16, 1024, 3)).astype(np.float32))
    with torch.inference_mode():
        want, we = cpu(x)
        got, ge = cpu.to(dev)(x.to(dev))
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, rtol=1e-4, atol=1e-5 * scale)
    torch.testing.assert_close(ge["transform"].cpu(), we["transform"],
                               rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("matching", ["nn", "emd"])
def test_matched_eval_kernel_path_matches_plain_path(dev, matching):
    """evaluate_samplenet_matched on the kernel path (point_mlp_max,
    nn_direction, fps) against the plain path on the card: unique NN
    counts equal, and on every cloud whose matched points are equal the
    correctness and the NLL (rtol 1e-4); nn matching equal on every
    cloud; emd matching's points those of each path's own transport
    argmax, and at most 0.5% of the argmaxes different between the paths
    (the f32 auction is chaotic: its steep levels multiply the simplified
    clouds' 3e-7 difference by up to 65536; chip_smoke.py's
    EMD_FLIP_SHARE)."""
    from samplenet_tpu_torch.models import PointNetClassifier, SampleNet
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.fps import gather_point
    from samplenet_tpu_torch.ops.matching import approx_match
    from samplenet_tpu_torch.train.evaluate import evaluate_samplenet_matched

    rng = np.random.default_rng(8)
    data = rng.standard_normal((96, 1024, 3)).astype(np.float32)
    labels = rng.integers(0, 10, 96)
    sampler = SampleNet(32, 128, generator=torch.Generator().manual_seed(9)
                        ).to(dev)
    cls = PointNetClassifier(10, generator=torch.Generator().manual_seed(10)
                             ).to(dev)
    # one batch: approx_match's reductions on the card sum in an order
    # that depends on the batch, so the argmax is recomputed on the same
    reset_launch_counts()
    got = evaluate_samplenet_matched(sampler, cls, data, labels, 96,
                                     matching=matching, device=dev)
    counts = launch_counts()
    for name in ("point_mlp_max", "nn_direction", "fps"):
        assert counts.get(name, 0) >= 1, counts
    with plain_on_cuda():
        want = evaluate_samplenet_matched(sampler, cls, data, labels, 96,
                                          matching=matching, device=dev)
    assert np.array_equal(got["unique_nn"], want["unique_nn"])
    same = (got["sampled"] == want["sampled"]).all(axis=(1, 2))
    if matching == "nn":
        assert same.all()
    else:
        x = torch.from_numpy(data).to(dev)
        with torch.inference_mode():
            simp_k = sampler.simplify(x)
            with plain_on_cuda():
                simp_p = sampler.simplify(x)
            mk, mp = approx_match(x, simp_k), approx_match(x, simp_p)

        ik, ip = mk.argmax(1), mp.argmax(1)
        assert int((ik != ip).sum()) <= 5e-3 * ik.numel()
        for r, i in ((got, ik), (want, ip)):
            assert np.array_equal(r["sampled"],
                                  gather_point(x, i).cpu().numpy())
    assert np.array_equal(got["correct"][same], want["correct"][same])
    np.testing.assert_allclose(got["nll"][same], want["nll"][same],
                               rtol=1e-4)


# ------------------------------------------------------------ bf16 modes

BF16_TOL = 1e-3       # norm-wise, against the plain bf16 version


def _max_bf16_case(rng, b, n, widths, dev):
    x = _randn(rng, b, n, widths[0], dev=dev)
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        wbs += [_randn(rng, cin, cout, dev=dev) / cin ** 0.5,
                0.1 * _randn(rng, cout, dev=dev)]
    return x, wbs


@pytest.mark.parametrize("b,n,widths", [
    (4, 1000, (3, 64, 64, 64, 128, 128)),     # N off the 64-point tile
    (2, 1, (3, 64, 64, 64, 128, 128)),
    (3, 77, (3, 12, 20)),                     # widths off the K step of 16
    (4, 300, (16, 24, 8)),                    # a first layer on mma.sync
    (3, 2048, (3, 64, 128, 128, 256, 128)),   # 256-wide layers
    (3, 300, (3, 64, 64, 64, 128, 130)),      # padded to 132
    (3, 300, (3, 64, 64, 64, 128, 1024)),     # bottleneck 1024
])
def test_point_mlp_max_bf16_matches_plain_bf16(dev, b, n, widths):
    """bf16 operands on mma.sync m16n8k16 (FP32 FMAs for a first layer of
    fewer than 16 channels) against the plain bf16 version, norm-wise
    within BF16_TOL, counted as point_mlp_max_bf16; the kernel with bf16
    off (3xTF32) exceeds it where the chain rounds often enough to show it
    (three or more layers, 256 points or more)."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_max, point_mlp_max_plain
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    x, wbs = _max_bf16_case(np.random.default_rng(b * 10 + n), b, n, widths,
                            dev)
    reset_launch_counts()
    with torch.no_grad():
        k = point_mlp_max(x, wbs, bf16=True)
        off = point_mlp_max(x, wbs)
        p = point_mlp_max_plain(x, wbs, True)
    assert launch_counts() == {"point_mlp_max_bf16": 1, "point_mlp_max": 1}
    gap, control = _norm_err(k, p), _norm_err(off, p)
    print(f"point_mlp_max bf16 {widths} B={b} N={n}: {gap!r}, bf16 off "
          f"{control!r}")
    assert gap <= BF16_TOL
    if b * n >= 256 and len(widths) > 3:
        assert control > BF16_TOL


def _exact_bf16_gaps(x, params, g, bf16):
    """(outputs gap, backward gap, backward bits repeat): the exact chain's
    kernels (bf16 on or off) against the plain bf16 version, norm-wise,
    the backward on the kernel forward's own state."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_kernel as pme

    from samplenet_tpu_torch.ops.cuda import point_mlp_train_kernel as pmt

    widths = [x.shape[-1], *(w.shape[1] for w in params[0])]
    if any(c % 4 for c in widths[1:]):     # the kernels run padded widths
        params = pmt.pad_params(widths, *params)
        g = torch.nn.functional.pad(g, (0, params[0][-1].shape[1]
                                        - g.shape[1]))
    weights, _, gammas, betas = params
    fk = pme.point_mlp_exact_fwd_cuda(x, weights, gammas, betas, 1e-5, bf16)
    fp = pme.point_mlp_exact_fwd_plain(x, weights, gammas, betas, 1e-5, True)
    bk = [pme.point_mlp_exact_bwd_cuda(x, weights, gammas, betas, fk[3], g,
                                       bf16) for _ in range(2)]
    zs, mus, rstds, argmax = fk[3]
    bp = pme.point_mlp_exact_bwd_plain(x, weights, gammas, betas,
                                       (zs, mus, rstds, argmax.long()), g,
                                       True)
    torch.cuda.synchronize()
    flat = lambda gr: [gr[0], *gr[1], *gr[2], *gr[3]]  # noqa: E731
    out = max(_norm_err(a, r) for a, r in zip(
        [fk[0], *fk[1], *fk[2]], [fp[0], *fp[1], *fp[2]]))
    bwd = max(_norm_err(a, r) for a, r in zip(flat(bk[0]), flat(bp)))
    same = all(torch.equal(a, c) for a, c in zip(flat(bk[0]), flat(bk[1])))
    return out, bwd, same


@pytest.mark.parametrize("b,n,widths", [
    (8, 1000, (3, 64, 64, 64, 128, 128)),   # N off the 64-point tile
    (3, 256, (3, 12, 20)),                  # widths off the K step
    (4, 1000, (3, 20, 36, 130)),            # off the K step of 16, padded
    (2, 300, (3, 64, 512)),                 # op(W)^T whole in bf16
    (50, 2048, (3, 64, 128, 128, 256, 128)),  # recon widths: K chunks
])
def test_point_mlp_exact_bf16_matches_plain_bf16(dev, b, n, widths):
    """The exact chain with bf16 operands (backward mode 2: xhat in f32,
    dh read back in bf16, rows from the unrounded dh) against the plain
    bf16 version, norm-wise within BF16_TOL: the forward, and the backward
    on the kernel forward's own state, bit for bit from run to run; the
    kernels with bf16 off exceed it; through autograd the dense biases get
    exact zeros and the launches count as point_mlp_exact_bf16_*."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_exact_train_max
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(b * 1000 + n + 16)
    x, params, g = _ghost_args(rng, b, n, widths, dev)
    out, bwd, same = _exact_bf16_gaps(x, params, g, True)
    out_off, bwd_off, _ = _exact_bf16_gaps(x, params, g, False)
    print(f"exact bf16 {widths} B={b} N={n}: {out!r}, {bwd!r}; bf16 off "
          f"{out_off!r}, {bwd_off!r}")
    assert out <= BF16_TOL and bwd <= BF16_TOL and same
    assert out_off > BF16_TOL and bwd_off > BF16_TOL
    xg = x.clone().requires_grad_(True)
    pg = [[t.clone().requires_grad_(True) for t in grp] for grp in params]
    reset_launch_counts()
    pooled, _, _ = point_mlp_exact_train_max(xg, *pg, bf16=True)
    (pooled * g).sum().backward()
    torch.cuda.synchronize()
    assert launch_counts() == {"point_mlp_exact_bf16_fwd": 1,
                               "point_mlp_exact_bf16_bwd": 1}
    assert not any(t.grad.any() for t in pg[1])


def test_bf16_train_chains_launch_the_tensor_core_kernels(dev):
    """The bf16 modes of both train chains through autograd count their
    launches under their names (point_mlp_exact_bf16_*, point_mlp_train_*),
    and the kernels they run issue HMMA (mma.sync m16n8k16 in bf16) in the
    built library's SASS: pmt_dense's bf16 instantiation, pmt_bwd_dw_mma in
    modes 1 and 2 and pmt_bwd_dz_mma in mode 2 (mode 1 keeps pmt_bwd_dz on
    the FP32 pipes); pmt_dense's f32 instantiation issues none."""
    import os
    import subprocess

    from samplenet_tpu_torch.ops.cuda import (
        point_mlp_exact_train_max,
        point_mlp_train_max,
    )
    from samplenet_tpu_torch.ops.cuda._build import find_nvcc, library_path
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(24)
    x, params, g = _ghost_args(rng, 8, 256, (3, 64, 64, 64, 128, 128), dev)
    for call, want in (
            (lambda *p: point_mlp_exact_train_max(*p, bf16=True),
             {"point_mlp_exact_bf16_fwd": 1, "point_mlp_exact_bf16_bwd": 1}),
            (lambda *p: point_mlp_train_max(*p, block_b=2, bf16=True),
             {"point_mlp_train_fwd": 1, "point_mlp_train_bwd": 1})):
        xg = x.clone().requires_grad_(True)
        pg = [[t.clone().requires_grad_(True) for t in grp] for grp in params]
        reset_launch_counts()
        pooled, _, _ = call(xg, *pg)
        (pooled * g).sum().backward()
        torch.cuda.synchronize()
        assert launch_counts() == want
    tool = os.path.join(os.path.dirname(find_nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library_path())],
                          capture_output=True, text=True, check=True).stdout
    hmma, name = {}, None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            hmma[name] = 0
        elif name is not None and "HMMA" in line:
            hmma[name] += 1
    for key, count in (("pmt_dense_kernelILb1E", 1),
                       ("pmt_bwd_dz_mma_kernelILi2E", 2),
                       ("pmt_bwd_dw_mma_kernel", 4)):
        mine = {k: v for k, v in hmma.items() if key in k}
        assert len(mine) == count and all(mine.values()), (key, mine)
    assert not any("pmt_bwd_dz_mma_kernelILi1E" in k for k in hmma)
    assert not any(v for k, v in hmma.items() if "pmt_dense_kernelILb0E" in k)


def test_eval_forward_bf16_matches_the_plain_matcher(dev):
    """SampleNet with eval_bf16: the forward launches point_mlp_max_bf16,
    and its hard matching equals the plain matcher's on its own
    simplified cloud, bit for bit."""
    from samplenet_tpu_torch.models import SampleNet
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        plain_on_cuda,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.ops.matching import nn_match_from_clouds

    net = SampleNet(16, 64, eval_bf16=True,
                    generator=torch.Generator().manual_seed(3)).to(dev).eval()
    x = _randn(np.random.default_rng(3), 6, 500, 3, dev=dev)
    reset_launch_counts()
    with torch.no_grad():
        simp, matched = net(x)
        counts = launch_counts()
        with plain_on_cuda():
            pts, _ = nn_match_from_clouds(x, simp, 16)
    assert counts == {"point_mlp_max_bf16": 1, "nn_direction": 1, "fps": 1}
    assert torch.equal(matched, pts)


# --------------------------------------------- the chains under a data mesh

def _chain_rank(mesh, chain, x, params, g, block_b):
    """One gloo rank on the card: the chain's kernels on its rows under the
    mesh; the outputs on its rows, the statistics, dx on its rows and the
    parameter gradients summed over the ranks."""
    from samplenet_tpu_torch.ops.cuda import (
        point_mlp_exact_train_max,
        point_mlp_train_max,
    )
    from samplenet_tpu_torch.ops.dispatch import launch_counts
    from samplenet_tpu_torch.parallel.mesh import (
        all_reduce_,
        batch_blocks,
        shard_batch,
    )

    dev = mesh.device
    x = shard_batch(mesh, x).to(dev).requires_grad_(True)
    params = [[t.to(dev).requires_grad_(True) for t in group]
              for group in params]
    blocks = batch_blocks(mesh, len(x), block_b)
    if chain == "exact":
        pooled, means, vars_ = point_mlp_exact_train_max(x, *params,
                                                         blocks=blocks)
    else:
        pooled, means, vars_ = point_mlp_train_max(
            x, *params, block_b=block_b, bf16=False, blocks=blocks)
    (pooled * shard_batch(mesh, g).to(dev)).sum().backward()
    grads = [all_reduce_(t.grad.clone(), mesh) for group in params
             for t in group]
    return {"out": [pooled.detach().cpu(), *(t.cpu() for t in means),
                    *(t.cpu() for t in vars_)],
            "dx": x.grad.cpu(), "grads": [t.cpu() for t in grads],
            "launches": launch_counts()}


@pytest.mark.parametrize("chain,b,block_b", [
    ("exact", 64, None),
    ("ghost", 16, 16),      # one block straddling both ranks
    ("ghost", 48, 16),      # 24 clouds a rank: blocks 8 + 16, 16, 16 + 8
])
def test_chains_under_a_two_rank_mesh(dev, chain, b, block_b):
    """2 gloo ranks sharing the card, each on its rows: the outputs and
    statistics within rtol = atol = 1e-4 of the one-process kernel run,
    the gradients each at most twice the larger of the one-process kernel
    run's and plain f32 run's errors against the plain float64 run (or
    1e-5 of scale), both kernels launched on every rank."""
    from samplenet_tpu_torch.parallel.launch import spawn

    rng = np.random.default_rng(b)
    widths = (3, 64, 64, 64, 128, 128)
    x, params = _exact_args(rng, b, 256, widths, dev)
    g = _randn(rng, b, widths[-1], dev=dev)
    if chain == "exact":
        run = _exact_run
    else:
        def run(x, params, g, plain=False, dtype=torch.float32):
            out, grads = _ghost_run(x, params, g, block_b, False, plain,
                                    dtype)
            return out[0], out[1:], grads
    pk, sk, gk = run(x, params, g)
    _, _, gp = run(x, params, g, plain=True)
    _, _, gr = run(x, params, g, plain=True, dtype=torch.float64)
    ranks = spawn(_chain_rank, 2, chain, x.cpu(), [[t.cpu() for t in grp]
                                                  for grp in params],
                  g.cpu(), block_b, device="cuda", timeout=300.0)
    nl = len(widths) - 1
    name = "point_mlp_exact" if chain == "exact" else "point_mlp_train"
    for r, out in enumerate(ranks):
        assert out["launches"].get(f"{name}_fwd", 0) == 1
        assert out["launches"].get(f"{name}_bwd", 0) == 1
        rows = slice(r * b // 2, (r + 1) * b // 2)
        torch.testing.assert_close(out["out"][0], pk[rows].cpu(), rtol=1e-4,
                                   atol=1e-4)
        for a, c in zip(out["out"][1:], sk):
            torch.testing.assert_close(a, c.cpu(), rtol=1e-4, atol=1e-4)
        for i, (a, k, c, ref) in enumerate(zip(
                [out["dx"], *out["grads"]], [gk[0][rows], *gk[1:]],
                [gp[0][rows], *gp[1:]], [gr[0][rows], *gr[1:]])):
            if 1 + nl <= i < 1 + 2 * nl:            # dense biases
                assert not a.any(), i
                continue
            ref = ref.cpu()
            ea, ek, ep = (_rel_err(t.cpu(), ref) for t in (a, k, c))
            assert ea <= max(2 * ek, 2 * ep, 1e-5), (i, ea, ek, ep)


# ------------------------------------- the kernels on weights of a 1 x 2 mesh

def _mlp_run(mesh=None):
    """A seeded PointMLP 3-64-128-512 with BN on the card (its last layer
    sharded over a model axis of 2 under `mesh`): the exact chain's train
    forward and backward, then point_mlp_max at eval, on 8 clouds of 256
    points; the whole outputs, gradients and state, and the launches."""
    from samplenet_tpu_torch.nn.layers import PointMLP
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )
    from samplenet_tpu_torch.parallel.mesh import (
        data_parallel,
        full_gradients,
        full_state_dict,
        shard_params,
        sharded_modules,
    )

    rng = np.random.default_rng(19)
    x = _randn(rng, 8, 256, 3, dev="cuda")
    g = _randn(rng, 8, 512, dev="cuda")
    mlp = PointMLP(3, (64, 128, 512),
                   generator=torch.Generator().manual_seed(4)).cuda()
    if mesh is not None:
        shard_params(mesh, data_parallel(mlp, mesh))
    reset_launch_counts()
    pooled = mlp(x, training=True, pool_max=True)
    (pooled * g).sum().backward()
    with torch.no_grad():
        evaled = mlp(x, pool_max=True)
    torch.cuda.synchronize()
    return {"pooled": pooled.detach().cpu(), "eval": evaled.cpu(),
            "grads": {k: v.cpu() for k, v in full_gradients(mlp).items()},
            "state": {k: v.cpu() for k, v in full_state_dict(mlp).items()},
            "sharded": [n for n, _ in sharded_modules(mlp)],
            "launches": launch_counts()}


def test_kernels_on_weights_gathered_from_a_1x2_mesh(dev):
    """2 gloo ranks of one model group sharing the card, conv3 and bn3
    (512 outputs) sharded: the exact chain and point_mlp_max take the
    whole weights all-gathered from the shards and give the one-process
    kernel run's bits: outputs, running statistics and gradients (the
    shards' slices of the whole-weight gradient, gathered back)."""
    from samplenet_tpu_torch.parallel.launch import spawn

    ref = _mlp_run()
    ranks = spawn(_mlp_run, 2, device="cuda", model=2, timeout=300.0)
    for out in ranks:
        assert out["sharded"] == ["conv3", "bn3"]
        for k in ("point_mlp_exact_fwd", "point_mlp_exact_bwd",
                  "point_mlp_max"):
            assert out["launches"].get(k, 0) == 1, (k, out["launches"])
        assert torch.equal(out["pooled"], ref["pooled"])
        assert torch.equal(out["eval"], ref["eval"])
        for part in ("grads", "state"):
            assert out[part].keys() == ref[part].keys()
            for k, v in ref[part].items():
                assert torch.equal(out[part][k], v), (part, k)


# ------------------------- the refusals repaired, the pruned wide forward

@pytest.mark.parametrize("layers", [9, 12])
@pytest.mark.parametrize("bf16", [False, True])
def test_point_mlp_max_past_eight_layers(dev, layers, bf16):
    """A chain deeper than the kernel's parameter table (8 layers) reads
    its table from device memory: against the plain version by the rules
    of the 5-layer chain (rtol = atol = 1e-4 in f32, norm-wise 1e-3 in
    bf16), launched."""
    from samplenet_tpu_torch.ops.cuda import (
        point_mlp_max,
        point_mlp_max_plain,
    )
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    rng = np.random.default_rng(layers + 10 * bf16)
    widths = [3] + [64, 128, 96, 64] * 3
    widths = widths[:layers + 1]
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        wbs += [_randn(rng, cin, cout, dev=dev) / np.sqrt(cin),
                0.1 * _randn(rng, cout, dev=dev)]
    x = _randn(rng, 33, 1000, 3, dev=dev)
    reset_launch_counts()
    got = point_mlp_max(x, wbs, bf16=bf16)
    torch.cuda.synchronize()
    assert launch_counts() == {
        "point_mlp_max_bf16" if bf16 else "point_mlp_max": 1}
    want = point_mlp_max_plain(x, wbs, bf16)
    if bf16:
        assert float((got - want).norm() / want.norm()) <= 1e-3
    else:
        torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)
    again = point_mlp_max(x, wbs, bf16=bf16)
    assert torch.equal(again, got)


# a cloud's tiles over S blocks: the chains (f32, bf16 and 9 layers, past
# the kernel's parameter table) at B below, at and above the SM count
SPLIT_MODES = {"f32": (False, (3, 64, 64, 64, 128, 128)),
               "bf16": (True, (3, 64, 64, 64, 128, 128)),
               "9 layers": (False, (3, 64, 128, 96, 64, 64, 128, 96, 64, 64))}


@pytest.mark.parametrize("n", [77, 1000, 1024, 2048])
@pytest.mark.parametrize("b", [1, 3, 32, 50, 131, 133])
@pytest.mark.parametrize("mode", list(SPLIT_MODES))
def test_point_mlp_max_split_is_bit_equal(dev, mode, b, n):
    """point_mlp_max with each cloud's 64-point tiles split over S = 2, 4
    and 16 blocks (and the plan's S) bit-equal to one block a cloud: max
    is exact and every tile computes what it computes at S = 1; the plan's
    launch through point_mlp_max, counted once."""
    from samplenet_tpu_torch.ops.cuda import point_mlp_kernel as pmk
    from samplenet_tpu_torch.ops.cuda import point_mlp_plan as mp
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    bf16, widths = SPLIT_MODES[mode]
    rng = np.random.default_rng(b * 7 + n)
    wbs = []
    for cin, cout in zip(widths[:-1], widths[1:]):
        wbs += [_randn(rng, cin, cout, dev=dev) / np.sqrt(cin),
                0.1 * _randn(rng, cout, dev=dev)]
    x = _randn(rng, b, n, 3, dev=dev)
    one = pmk.launch_max(x, wbs, bf16=bf16, splits=1)
    for s in (2, 4, 16):
        assert torch.equal(pmk.launch_max(x, wbs, bf16=bf16, splits=s),
                           one), s
    plan = pmk.max_splits_for(x, widths, bf16)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    resident = pmk._resident(x.device.index, mp.kernel_widths(widths), bf16)
    assert resident >= 1
    assert plan == mp.max_splits(b, n, sms=sms, resident=resident)
    reset_launch_counts()
    got = pmk.point_mlp_max(x, wbs, bf16=bf16)
    torch.cuda.synchronize()
    assert launch_counts() == {
        "point_mlp_max_bf16" if bf16 else "point_mlp_max": 1}
    assert torch.equal(got, one), plan


def test_strided_inputs_give_the_contiguous_bits(dev):
    """nn_direction, nn_snap and point_mlp_max take strided CUDA tensors,
    made contiguous at the entry: bit-equal to the contiguous call."""
    from samplenet_tpu_torch.ops.cuda import (
        nn_direction,
        nn_snap,
        point_mlp_max,
    )

    rng = np.random.default_rng(3)
    x = _randn(rng, 4, 3, 700, dev=dev).transpose(1, 2)   # [4, 700, 3]
    y = _randn(rng, 4, 1000, 6, dev=dev)[..., ::2]        # [4, 1000, 3]
    assert not x.is_contiguous() and not y.is_contiguous()
    for fn in (nn_direction, nn_snap):
        got, want = fn(x, y), fn(x.contiguous(), y.contiguous())
        assert all(torch.equal(a, c) for a, c in zip(got, want))
    wbs = [_randn(rng, 3, 64, dev=dev), _randn(rng, 64, dev=dev),
           _randn(rng, 64, 128, dev=dev) / 8, _randn(rng, 128, dev=dev)]
    for bf16 in (False, True):
        assert torch.equal(point_mlp_max(x, wbs, bf16=bf16),
                           point_mlp_max(x.contiguous(), wbs, bf16=bf16))


def test_emd_past_one_launch_of_clouds(dev):
    """B = 65,537 clouds of 32 points: two launches (65,535 and 2 clouds),
    each chunk's outputs bit-equal to a call on its clouds alone. Against
    the plain version in f64, by test_emd_matches_plain_and_f64's rule for
    the gradients: the kernel's worst relative cost error over the clouds
    at most 1.5x the plain f32 version's, or 2e-4 (among 65,537 randn
    clouds some meet the auction's near-ties, where both f32 paths drift
    from f64 by about 1%), and the second chunk's gradients the same way,
    or 5e-4."""
    from samplenet_tpu_torch.ops.cuda import emd_cost, emd_cost_plain
    from samplenet_tpu_torch.ops.cuda import emd_kernel as ek
    from samplenet_tpu_torch.ops.dispatch import (
        launch_counts,
        reset_launch_counts,
    )

    b = ek.MAX_CLOUDS + 2
    rng = np.random.default_rng(65537)
    x1, x2 = _randn(rng, b, 32, 3, dev=dev), _randn(rng, b, 32, 3, dev=dev)
    reset_launch_counts()
    full = emd_cost(x1, x2)
    torch.cuda.synchronize()
    assert launch_counts() == {"emd": 2}
    for c0, c1 in ek.cloud_chunks(b):
        part = emd_cost(x1[c0:c1], x2[c0:c1])
        assert all(torch.equal(f[c0:c1], p) for f, p in zip(full, part))
    ref = emd_cost_plain(x1.double(), x2.double(), with_grads=False)[0]
    plain = emd_cost_plain(x1, x2, with_grads=False)[0]

    def cost_err(c):
        return float(((c.double() - ref).abs() / ref.abs()).max())

    print(f"\nemd B={b}: worst relative cost error against f64, kernel "
          f"{cost_err(full[0])!r}, plain f32 {cost_err(plain)!r}")
    assert cost_err(full[0]) <= max(1.5 * cost_err(plain), 2e-4)
    tail = slice(ek.MAX_CLOUDS, b)
    _, r1, r2 = emd_cost_plain(x1[tail].double(), x2[tail].double())
    _, p1, p2 = emd_cost_plain(x1[tail], x2[tail])
    for got, plain, ref in ((full[1][tail], p1, r1), (full[2][tail], p2, r2)):
        assert _rel_err(got, ref) <= max(1.5 * _rel_err(plain, ref), 5e-4)


def test_soft_projection_backward_past_int_entries(dev):
    """One cloud of 2^26 queries at k = 32: 2^31 entries, past what an int
    numbers, so the point kernel counts them in 64 bits. The first half of
    the queries names points 0..127 only and the second half 128..255, so
    each point's entries all come from one half, in the same order: d
    points equals the sum of the two halves' (each under 2^31 entries,
    the int-counted kernel) bit for bit, d queries their concatenation bit
    for bit, and d sigma^2 (2^31 f32 terms summed in 256 stripes, grouped
    otherwise in the halves) within rtol 1e-2 of the halves' sum."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp

    n, m, k = 256, 2**26, 32
    assert spp.counts_in_64_bits(m, k)
    assert not spp.counts_in_64_bits(m // 2, k)
    if torch.cuda.get_device_properties(dev).total_memory < 70 * 2**30:
        pytest.skip("needs about 63 GB of device memory")
    gen = torch.Generator(device=dev).manual_seed(31)
    pts = torch.randn(1, n, 3, device=dev, generator=gen)
    qs = torch.randn(1, m, 3, device=dev, generator=gen)
    cot = torch.randn(1, m, 3, device=dev, generator=gen)
    # idx is not sorted by distance: a sigma^2 above the clouds' squared
    # diameter keeps every weight exp(-(d_j - d_0) / sigma^2) finite
    sigma = torch.tensor([100.0], device=dev)
    idx = torch.randint(0, n // 2, (1, m, k), dtype=torch.int32, device=dev,
                        generator=gen)
    idx[:, m // 2:] += n // 2
    dp, dq, ds = spk.soft_project_bwd_cuda(pts, qs, sigma, idx, cot)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    halves = [spk.soft_project_bwd_cuda(
        pts, qs[:, h].contiguous(), sigma, idx[:, h].contiguous(),
        cot[:, h].contiguous()) for h in (slice(0, m // 2), slice(m // 2, m))]
    assert torch.equal(dp, halves[0][0] + halves[1][0])
    assert torch.equal(dq, torch.cat([halves[0][1], halves[1][1]], 1))
    assert torch.isfinite(dp).all() and dp.abs().sum() > 0
    torch.testing.assert_close(ds, halves[0][2] + halves[1][2], rtol=1e-2,
                               atol=0)


# (B, N, M, k) of chip_smoke.py's CAPS_SOFT
CAPS_SOFT_SHAPES = [(1024, 1024, 32, 32), (4, 1024, 64, 256),
                    (4, 32768, 64, 32)]


def _wide_plans(b, n, m, k, dev):
    """The planned wide forward and every other plan the kernels take at
    the shape: the radix kernel, and the pruned one at each split."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_plan as spp

    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    plans = [spp.plan_fwd_wide(b, n, m, k, sms=sms),
             spp.WideFwdPlan(0, 1, 0, 0, 0, 0, -(-b * m // 8))]
    for ws in (1, 2, 4, 8):
        for cs in (1, 2, 4, 8):
            try:
                plans.append(spp.pruned_plan(b, n, m, k, ws, cs))
            except ValueError:
                pass
    return list(dict.fromkeys(plans))


@pytest.mark.parametrize("b,n,m,k", CAPS_SOFT_SHAPES)
def test_wide_forward_at_the_caps_shapes(dev, b, n, m, k):
    """The wide forward at each CAPS_SOFT shape: idx bit-equal to the plain
    version, out within 1e-5, under the plan and, at B = 4, under every
    other plan the kernels take (each bit-equal to the planned launch)."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    pts, qs, sigma = _soft_fwd_inputs("randn", b, n, m, b + n + k, dev)
    ok, ik = spk.soft_project_fwd_cuda(pts, qs, sigma, k)
    torch.cuda.synchronize()
    _soft_fwd_check(pts, qs, sigma, k, ok, ik)
    if b > 4:
        return
    for plan in _wide_plans(b, n, m, k, dev):
        o, i = spk.launch_fwd_wide(pts, qs, sigma, k, plan)
        torch.cuda.synchronize()
        assert torch.equal(i, ik), plan
        torch.testing.assert_close(o, ok, rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind,b,n,m,k", [
    ("triples", 4, 1024, 64, 32),    # ties: every point three times
    ("same", 2, 2048, 40, 32),       # one point 2048 times: the buffer
    ("nan", 3, 4096, 20, 48),        # NaN points and queries
    ("cluster", 2, 8192, 9, 20),     # 512 candidates near the first query
    ("randn", 1, 65536, 3, 64),      # one cloud, few queries: clusters
])
def test_pruned_wide_forward_on_ties_and_overflow(dev, kind, b, n, m, k):
    """Ties, NaN, a candidate list past its buffer (the radix selection
    over the whole cloud takes the query) and splits over clusters: idx
    bit-equal to the plain version under the plan and under every other
    plan the kernels take."""
    from samplenet_tpu_torch.ops.cuda import soft_projection_kernel as spk

    pts, qs, sigma = _soft_fwd_inputs(
        "triples" if kind == "same" else kind, b, n, m, n + k, dev)
    if kind == "same":
        pts[:] = pts[:, :1]
    for plan in _wide_plans(b, n, m, k, dev):
        o, i = spk.launch_fwd_wide(pts, qs, sigma, k, plan)
        torch.cuda.synchronize()
        _soft_fwd_check(pts, qs, sigma, k, o, i)

