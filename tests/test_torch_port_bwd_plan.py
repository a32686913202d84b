"""The launch planner of the train chains' backward kernels
(`samplenet_tpu_torch/ops/cuda/point_mlp_plan.py`), on the CPU: it is pure
Python, and the CUDA wrappers launch pmt_bwd_dz and pmt_bwd_dw with what
it returns (they check on the card that the kernels count shared memory as
it does).

Over every width pair of the three tracks (classification sampler 3->64
.. 128->128, reconstruction 64->128 .. 256->128) at each track's point
count, on an H100 (132 SMs, 232,448 bytes of shared memory per block):
both passes fit a block and leave room for at least two blocks per SM,
so no width needs the input-channel slabs the one-pass backward took; the dz pass's threads cover its tile, at least 4 points a thread
from 64-wide inputs on; and the dW grid, which fixes the order of its f64
partial sums, depends only on the shape and the SM count.
"""

import pytest

from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan

H100_SMS, H100_SMEM = 132, 232448
CLS = ((3, 64), (64, 64), (64, 128), (128, 128))
RECON = ((3, 64), (64, 128), (128, 128), (128, 256), (256, 128))
CASES = ([(ci, co, 1, 1024 * 1024) for ci, co in CLS]          # B=1024
         + [(ci, co, 1, 50 * 2048) for ci, co in RECON]         # B=50
         + [(ci, co, 8, 4 * 1024) for ci, co in CLS])           # ghost, bb 4


@pytest.mark.parametrize("cin,cout,n_blocks,m", CASES)
def test_plan_fits_the_card(cin, cout, n_blocks, m):
    p = plan.plan_layer(cin, cout, n_blocks, m, H100_SMS, H100_SMEM)
    assert p is not None
    assert p.cin_pad == -(-cin // 4) * 4
    assert p.dz_smem == plan.dz_smem(p.cin_pad, cout, p.dz_kc, p.dz_stage)
    assert p.dz_smem <= H100_SMEM and p.dw_smem <= H100_SMEM
    assert plan.blocks_per_sm(p.dw_smem, plan.DW_THREADS) >= 2
    assert plan.blocks_per_sm(p.dw_smem, plan.DW_THREADS) \
        >= plan.DW_BLOCKS_PER_SM[p.dw_ri]
    # both passes keep two blocks or more on each SM at the tracks' widths
    assert plan.blocks_per_sm(p.dz_smem, plan.DZ_THREADS) >= 2
    if p.dz_stage:   # staging only where it leaves two blocks an SM
        assert p.dz_kc == cout
    # the dz pass: K chunks of W^T that are multiples of 4, every dh_prev
    # output of a 64-point tile owned once
    assert p.dz_kc % 4 == 0 and 4 <= p.dz_kc <= cout
    threads = (plan.TILE // p.dz_rp) * (p.cin_pad // 4)
    assert plan.TILE % p.dz_rp == 0 and threads <= plan.DZ_THREADS
    if cin >= 64:
        assert p.dz_rp >= 4 and threads == plan.DZ_THREADS
    assert p.dw_ri == (8 if cout >= 128 else 4)
    tiles = n_blocks * -(-m // plan.TILE)
    assert 1 <= p.dw_splits <= tiles
    assert p.dw_out_tiles == (-(-p.cin_pad // 64)) * (
        -(-cout // plan.dw_to(p.dw_ri)))
    assert 1 <= p.dz_grid <= tiles


@pytest.mark.parametrize("cin,cout,n_blocks,m", CASES)
def test_dw_grid_depends_only_on_shape_and_sms(cin, cout, n_blocks, m):
    args = (cin, cout, n_blocks, m)
    first = plan.plan_layer(*args, H100_SMS, H100_SMEM)
    assert plan.plan_layer(*args, H100_SMS, H100_SMEM) == first
    other = plan.plan_layer(*args, H100_SMS, 200000)
    assert (other.dw_out_tiles, other.dw_splits) == (first.dw_out_tiles,
                                                     first.dw_splits)
    fewer = plan.plan_layer(*args, 66, H100_SMEM)
    assert fewer.dw_splits <= first.dw_splits
    assert fewer.dw_splits == max(1, min(
        n_blocks * -(-m // plan.TILE),
        -(-plan.DW_BLOCKS_PER_SM[first.dw_ri] * 66 // first.dw_out_tiles)))


@pytest.mark.parametrize("widths,n_blocks,m", [
    ((3, 64, 64, 64, 128, 128), 1, 1024 * 1024),
    ((3, 64, 128, 128, 256, 128), 1, 50 * 2048),
    ((3, 64, 64, 64, 128, 128), 8, 4096),
])
def test_plan_bwd_covers_each_layer(widths, n_blocks, m):
    plans = plan.plan_bwd(widths, n_blocks, m, H100_SMS, H100_SMEM)
    assert [(p.cin, p.cout) for p in plans] == list(zip(widths[:-1],
                                                        widths[1:]))
    # the widths that fit whole today keep op(W)^T resident
    for p in plans:
        if p.cout * p.cin_pad <= 128 * 128:
            assert p.dz_kc == p.cout


def test_wide_layers_take_k_chunks():
    """op(W)^T in K chunks where it would leave one block an SM (the
    reconstruction track's 128 -> 256), or where it does not fit at all
    (64 -> 512: one staged block an SM)."""
    wide = plan.plan_layer(128, 256, 1, 102400, H100_SMS, H100_SMEM)
    assert wide.dz_kc < 256 and not wide.dz_stage
    assert plan.blocks_per_sm(wide.dz_smem, plan.DZ_THREADS) == 2
    widest = plan.plan_layer(64, 512, 1, 600, H100_SMS, H100_SMEM)
    assert widest.dz_kc < 512 and widest.dz_smem <= H100_SMEM


def test_refuses_what_does_not_fit():
    assert plan.plan_layer(64, 6, 1, 1000, H100_SMS, H100_SMEM) is None
    assert plan.plan_layer(64, 4096, 1, 1000, H100_SMS, H100_SMEM) is None
    assert plan.plan_bwd((3, 64, 4096), 1, 1000, H100_SMS, H100_SMEM) is None
    assert plan.plan_layer(64, 64, 1, 1000, H100_SMS, 60000) is None
