"""The launch planner of the train chains' backward kernels
(`samplenet_tpu_torch/ops/cuda/point_mlp_plan.py`), on the CPU: it is pure
Python, and the CUDA wrappers launch pmt_bwd_dz and pmt_bwd_dw with what
it returns (they check on the card that the kernels count shared memory as
it does).

Over every width pair of the three tracks (classification sampler 3->64
.. 128->128, reconstruction 64->128 .. 256->128) and the bottleneck of
1024 (128->1024, the AE's 256->1024) at each track's point count, on an
H100 (132 SMs, 232,448 bytes of shared memory per block): both passes fit
a block and leave room for at least two blocks per SM, so no width needs
the input-channel slabs the one-pass backward took; the dz pass's threads
cover its tile, at least 4 points a thread from 64-wide inputs on; and
the dW grid, which fixes the order of its f64 partial sums, depends only
on the shape and the SM count. Every plan of those pairs but the 1024-wide
ones is pinned field for field to the plan it had before the chunked
layout came in.

The chunked layout (dz in chunks of `dz_oc` output channels) is taken
only where none of the other five fits: from 768 outputs on at 128
inputs. With it, `plan_bwd` plans SampleNet's chain at every bottleneck
from 4 to 4096, and one layer at every input width up to 1024 with up to
4096 outputs; there it may leave a single block an SM (1024 -> 4096).
"""

import pytest

from samplenet_tpu_torch.ops.cuda import point_mlp_plan as plan

H100_SMS, H100_SMEM = 132, 232448
CLS = ((3, 64), (64, 64), (64, 128), (128, 128))
RECON = ((3, 64), (64, 128), (128, 128), (128, 256), (256, 128))
CASES = ([(ci, co, 1, 1024 * 1024) for ci, co in CLS]          # B=1024
         + [(ci, co, 1, 50 * 2048) for ci, co in RECON]         # B=50
         + [(ci, co, 8, 4 * 1024) for ci, co in CLS]            # ghost, bb 4
         + [(128, 1024, 1, 1024 * 1024), (128, 1024, 1, 32 * 1024),
            (256, 1024, 1, 50 * 2048)])                         # bottleneck
# (cin, cout, n_blocks, m) -> (cin_pad, dz_rp, dz_kc, dz_stage, dz_smem,
# dz_grid, dw_ri, dw_out_tiles, dw_splits, dw_smem): the plans before the
# chunked layout, which must not move
PINNED = {
    (3, 64, 1, 1048576): (4, 1, 64, True, 53504, 528, 4, 1, 396, 65536),
    (64, 64, 1, 1048576): (64, 4, 64, True, 68864, 396, 4, 1, 396, 65536),
    (64, 128, 1, 1048576): (64, 4, 128, False, 71680, 396, 8, 1, 264, 98304),
    (128, 128, 1, 1048576): (128, 8, 128, False, 104448, 264, 8, 2, 132,
                             98304),
    (3, 64, 1, 32768): (4, 1, 64, True, 53504, 512, 4, 1, 396, 65536),
    (64, 64, 1, 32768): (64, 4, 64, True, 68864, 396, 4, 1, 396, 65536),
    (64, 128, 1, 32768): (64, 4, 128, False, 71680, 396, 8, 1, 264, 98304),
    (128, 128, 1, 32768): (128, 8, 128, False, 104448, 264, 8, 2, 132, 98304),
    (3, 64, 8, 4096): (4, 1, 64, True, 53504, 512, 4, 1, 396, 65536),
    (64, 64, 8, 4096): (64, 4, 64, True, 68864, 396, 4, 1, 396, 65536),
    (64, 128, 8, 4096): (64, 4, 128, False, 71680, 396, 8, 1, 264, 98304),
    (128, 128, 8, 4096): (128, 8, 128, False, 104448, 264, 8, 2, 132, 98304),
    (3, 64, 1, 102400): (4, 1, 64, True, 53504, 528, 4, 1, 396, 65536),
    (64, 128, 1, 102400): (64, 4, 128, False, 71680, 396, 8, 1, 264, 98304),
    (128, 128, 1, 102400): (128, 8, 128, False, 104448, 264, 8, 2, 132,
                            98304),
    (128, 256, 1, 102400): (128, 8, 64, False, 110080, 264, 8, 4, 66, 98304),
    (256, 128, 1, 102400): (256, 16, 64, False, 104448, 264, 8, 4, 66, 98304),
    (128, 512, 1, 1048576): (128, 8, 128, False, 219648, 132, 8, 8, 33,
                             98304),
    (128, 512, 1, 32768): (128, 8, 128, False, 219648, 132, 8, 8, 33, 98304),
    (64, 512, 1, 600): (64, 4, 256, False, 219648, 10, 8, 4, 10, 98304),
    (128, 640, 1, 32768): (128, 8, 72, False, 229376, 132, 8, 10, 27, 98304),
}
PINNED_FIELDS = ("cin_pad", "dz_rp", "dz_kc", "dz_stage", "dz_smem",
                 "dz_grid", "dw_ri", "dw_out_tiles", "dw_splits", "dw_smem")
SAMPLENET = (3, 64, 64, 64, 128)     # the sampler's chain below its bottleneck


@pytest.mark.parametrize("cin,cout,n_blocks,m", CASES)
def test_plan_fits_the_card(cin, cout, n_blocks, m):
    p = plan.plan_layer(cin, cout, n_blocks, m, H100_SMS, H100_SMEM)
    assert p is not None
    assert p.cin_pad == -(-cin // 4) * 4
    assert p.dz_smem == plan.dz_smem(p.cin_pad, cout, p.dz_kc, p.dz_stage,
                                     p.dz_oc)
    assert p.dz_smem <= H100_SMEM and p.dw_smem <= H100_SMEM
    # dz whole, or chunks of dz_oc channels with as many rows of W^T
    assert p.dz_oc == cout or (p.dz_kc == p.dz_oc < cout
                               and not p.dz_stage)
    assert (p.dz_oc < cout) == (cout >= 768)
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


@pytest.mark.parametrize("case", list(PINNED))
def test_plans_before_the_chunked_layout_stay(case):
    p = plan.plan_layer(*case, H100_SMS, H100_SMEM)
    assert (p.cin, p.cout, p.dz_oc) == (case[0], case[1], case[1])
    assert tuple(getattr(p, f) for f in PINNED_FIELDS) == PINNED[case]


@pytest.mark.parametrize("b", [32, 1024])
def test_plan_bwd_takes_every_bottleneck(b):
    """SampleNet's chain at every bottleneck 4 .. 4096 at the
    classification (B=1024) and progressive (B=32) point counts: a plan,
    the bottleneck layer chunked exactly from 768 on (planned at the next
    multiple of 4, which the wrappers pad it to)."""
    for c in range(4, 4097):
        plans = plan.plan_bwd(SAMPLENET + (c,), 1, b * 1024, H100_SMS,
                              H100_SMEM)
        assert plans is not None, c
        top = plans[-1]
        assert top.cout == plan.pad4(c) and top.dz_smem <= H100_SMEM
        assert (top.dz_oc < top.cout) == (top.cout >= 768), c
        assert [p.dz_oc for p in plans[:-1]] == [64, 64, 64, 128]


def test_plan_bwd_takes_the_ae_encoder_at_bottleneck_1024():
    plans = plan.plan_bwd((3, 64, 128, 128, 256, 1024), 1, 50 * 2048,
                          H100_SMS, H100_SMEM)
    assert plans is not None and plans[-1].dz_oc < 1024
    assert plan.blocks_per_sm(plans[-1].dz_smem, plan.DZ_THREADS) >= 2


@pytest.mark.parametrize("cout", [768, 1024, 2048, 4096])
def test_chunked_layout_fits_every_input_width(cout):
    """One layer at every cin up to 1024 (each multiple of 4, and 3):
    planned, within the card's shared memory, one block an SM or more;
    chunked only where the five layouts before it leave no room."""
    for cin in (3, *range(4, 1025, 4)):
        p = plan.plan_layer(cin, cout, 1, 32 * 1024, H100_SMS, H100_SMEM)
        assert p is not None, cin
        assert p.dz_smem <= H100_SMEM, cin
        assert plan.blocks_per_sm(p.dz_smem, plan.DZ_THREADS) >= 1, cin
        assert p.dz_oc % 4 == 0 and 4 <= p.dz_oc <= cout
        if p.dz_oc < cout:
            assert plan._dz_layout(p.cin_pad, cout, H100_SMEM)[2] == p.dz_oc
            half = (H100_SMEM + plan.SMEM_RESERVED) // 2 - plan.SMEM_RESERVED
            # no K-chunk layout of dz whole fits one block
            assert plan.dz_smem(p.cin_pad, cout, 4, False) > H100_SMEM
            # two blocks an SM wherever chunks of 32 channels leave room
            if p.dz_smem > half:
                assert plan.dz_smem(p.cin_pad, cout, 32, False, 32) > half
            else:
                assert p.dz_oc >= 32


def test_chunk_cap_moves_only_chunked_layers():
    """`oc_cap` (the card check's smaller chunks) narrows the chunks of a
    chunked layer and leaves every other plan as it was."""
    args = (1, 1024 * 1024, H100_SMS, H100_SMEM)
    wide = plan.plan_layer(128, 1024, *args)
    capped = plan.plan_layer(128, 1024, *args, oc_cap=48)
    assert wide.dz_oc == 128 and capped.dz_oc == capped.dz_kc == 48
    assert capped.dz_smem == plan.dz_smem(128, 1024, 48, False, 48)
    for cin, cout in CLS + RECON:
        assert plan.plan_layer(cin, cout, *args, oc_cap=48) \
            == plan.plan_layer(cin, cout, *args)


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
    # what the chunked layout and the padding now take: 6 outputs planned
    # at 8, 4096 outputs in chunks
    assert plan.plan_layer(64, 6, 1, 1000, H100_SMS, H100_SMEM) \
        == plan.plan_layer(64, 8, 1, 1000, H100_SMS, H100_SMEM)
    assert plan.plan_layer(64, 4096, 1, 1000, H100_SMS, H100_SMEM).dz_oc \
        < 4096
    assert plan.plan_bwd((3, 64, 4096), 1, 1000, H100_SMS, H100_SMEM)
    # a chunk of 4 rows of W^T that passes the limit; dW's tile over it
    assert plan.plan_layer(16384, 64, 1, 1000, H100_SMS, H100_SMEM) is None
    assert plan.plan_layer(64, 64, 1, 1000, H100_SMS, 60000) is None
