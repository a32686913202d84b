"""Launch plans of the per-point MLP kernels: pure Python, so that the CPU
tests reach them (csrc/point_mlp_train.cu, csrc/point_mlp_max.cu and
csrc/mma_tile.cuh; the constants below are the kernels' own).

The forward kernels, pmt_dense (each layer of the train chains' forward)
and point_mlp_max (the eval chain), hold a 64-point tile of activations in
shared memory, one row of 64 f32 words per input channel, the rows
rounded up to the tensor cores' K step of 8 (point_mlp_max's layers of 8
or more input channels) or to 4 (the FP32 FMAs of pmt_dense and of a
first layer of fewer than 8 channels). W needs no shared memory and no K
chunks: it is read through the read-only cache, so shared memory holds
only what the tile needs and two or more blocks share an SM at every
width the tracks run:

- pmt_dense: the tile of `cin` channels, the layer below's BN constants
  [4, cin], a chunk of up to 64 output channels of the tile's z [.., 68]
  (each channel's z and z^2 are summed from it in point order), the
  block's f64 sums [2, cout] and, where two blocks still share an SM with
  it, the next tile's raw rows [64, cin + 4], staged by cp.async while the
  tile's products run (`stage`; cin a multiple of 4).
- point_mlp_max: two tile buffers, each as tall as the widest layer it
  holds (buffer 0: x and the outputs of layers 1, 3, ...; buffer 1: those
  of layers 0, 2, ...; the last layer's output is not stored), and the
  per-channel max [cout_last]. With bf16 operands a row holds two
  channels (a pair of bf16 in each word) and the K step is 16 channels,
  so a layer's rows are half as many; a first layer of fewer than 16
  channels runs on the FP32 pipes and keeps x in f32 rows.

The backward:

Per layer (cin -> cout) the backward runs two passes:

- `pmt_bwd_dz` walks the 64-point tiles (none crossing a ghost block) and
  writes dz and dh_prev = dz op(W)^T. A block holds the tile's
  dz, its ghost block's per-channel constants and `dz_kc` rows of op(W)^T
  at a time (all cout rows where they fit, else K chunks loaded per
  tile); with `dz_stage` also the next tile's raw z and dh rows, staged
  with cp.async while the tile's product runs. Staging costs 2 x 64 x cout
  floats, so it is taken only where two blocks still share an SM (the
  64-wide layers): a lone block per SM stalls between its phases, and two
  unstaged blocks overlap each other's. Each thread owns `dz_rp` points x
  4 channels of dh_prev. The grid only spreads work: dz and dh_prev do
  not depend on it.
- `pmt_bwd_dw` computes dW = op(act(h_prev))^T dz by split-K over the 64-
  point tiles: a grid of (output tiles of [cin_pad, cout]: 64 input x 64
  output channels at `dw_ri` = 4, 64 x 128 at 8) x `dw_splits` runs of
  consecutive tiles. Each tile is summed in f32, the tiles of a run in f64
  registers, and the runs' f64 partials by the caller in a fixed order;
  `dw_splits` depends only on the shape and the SM count, so the bits
  repeat from run to run.

Shared memory is counted as the kernels count it; a plan is refused
(None) where a pass does not fit the card's per-block limit.
"""

from __future__ import annotations

from dataclasses import dataclass

TILE = 64             # points per tile of the dW sums (kTileP)
DZ_THREADS = 256      # kDzThreads
DZ_RPS = (1, 2, 4, 8, 16)
DW_THREADS = 128      # kDwThreads
DW_TILE = 64          # kDwTile: input channels of a dW output tile


def dw_to(ri: int) -> int:
    """Output channels of a dW output tile (dw_to<kRI>)."""
    return DW_THREADS * ri * 8 // DW_TILE


def dw_ri(cout: int) -> int:
    """Input channels a dW thread owns (x 8 output channels): 8 where cout
    fills the 128-wide output tile that takes (4 FMA per float read from
    shared memory, against 2.7 at 4 x 8), else 4."""
    return 8 if cout >= dw_to(8) else 4


def dw_smem(ri: int) -> int:
    """Two stages of a 64-point tile of act(h_prev), 64 channels, and of
    dz, dw_to(ri) channels (snt_pmt_bwd_dw_smem)."""
    return 4 * 2 * TILE * (DW_TILE + dw_to(ri))


# blocks per SM the dW kernel is built for (its launch bounds), which its
# shared memory leaves room for in an H100 SM's 228 KB
DW_BLOCKS_PER_SM = {4: 3, 8: 2}
SMEM_RESERVED = 1024  # shared memory the card reserves per resident block
MAX_THREADS_PER_SM = 2048


@dataclass(frozen=True)
class LayerPlan:
    cin: int
    cout: int
    cin_pad: int
    dz_rp: int        # points per thread in its dh_prev product
    dz_kc: int        # rows of op(W)^T in shared memory at once
    dz_stage: bool    # cp.async stages the next tile's z and dh rows
    dz_smem: int      # bytes per block
    dz_grid: int
    dw_ri: int
    dw_out_tiles: int
    dw_splits: int
    dw_smem: int


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def dz_smem(cin_pad: int, cout: int, kc: int, stage: bool) -> int:
    """Bytes of a pmt_bwd_dz block (csrc: snt_pmt_bwd_dz_smem): op(W)^T
    rows [kc, cin_pad], 7 per-channel constants, dz channel-major
    [cout, 68], each point's cloud and index [2, 64], and with `stage` the
    raw z and dh rows [2, 64, cout]."""
    return 4 * (kc * cin_pad + 7 * cout + cout * (TILE + 4) + 2 * TILE
                + (2 * TILE * cout if stage else 0))


def blocks_per_sm(smem: int, threads: int,
                  limit: int = 232448) -> int:
    """Resident blocks per SM by shared memory and threads: an SM holds
    the per-block limit plus one reservation."""
    by_smem = (limit + SMEM_RESERVED) // (smem + SMEM_RESERVED)
    return max(0, min(by_smem, MAX_THREADS_PER_SM // threads))


def _dz_layout(cin_pad: int, cout: int, limit: int):
    """(kc, stage) for pmt_bwd_dz, the first that fits of: two blocks to an
    SM with op(W)^T whole and the rows staged; the same unstaged; two
    blocks with K chunks of at least 32 rows, unstaged; one block with
    chunks of at least 4 rows, staged, then unstaged. Chunks are the
    fewest equal multiples of 4 that fit."""
    half = (limit + SMEM_RESERVED) // 2 - SMEM_RESERVED
    for budget, stage, kc_min in ((half, True, cout), (half, False, cout),
                                  (half, False, min(cout, 32)),
                                  (limit, True, 4), (limit, False, 4)):
        room = (budget - dz_smem(cin_pad, cout, 0, stage)) // (4 * cin_pad)
        kc_max = min(cout, room // 4 * 4)
        if kc_max >= max(4, kc_min):
            chunks = _ceil(cout, kc_max)
            return min(kc_max, _ceil(_ceil(cout, chunks), 4) * 4), stage
    return None


def _dz_rp(cin_pad: int) -> int:
    """The fewest points per thread that cover a tile's dh_prev
    (64 x cin_pad, 4 channels a thread) with the block's threads; at most
    16 (wider layers take several passes)."""
    for rp in DZ_RPS:
        if (TILE // rp) * (cin_pad // 4) <= DZ_THREADS:
            return rp
    return DZ_RPS[-1]


def plan_layer(cin: int, cout: int, n_blocks: int, m: int, sms: int,
               limit: int) -> LayerPlan | None:
    """The plan of one layer for `n_blocks` ghost blocks of `m` points
    each, on a card with `sms` SMs and `limit` bytes of shared memory per
    block; None where a pass does not fit."""
    cin_pad = _ceil(cin, 4) * 4
    layout = _dz_layout(cin_pad, cout, limit)
    ri = dw_ri(cout)
    if layout is None or cout % 4 or dw_smem(ri) > limit:
        return None
    kc, stage = layout
    smem = dz_smem(cin_pad, cout, kc, stage)
    tiles = n_blocks * _ceil(m, TILE)
    dz_grid = max(1, min(tiles, blocks_per_sm(smem, DZ_THREADS, limit) * sms))
    out_tiles = _ceil(cin_pad, DW_TILE) * _ceil(cout, dw_to(ri))
    splits = max(1, min(tiles, _ceil(DW_BLOCKS_PER_SM[ri] * sms, out_tiles)))
    return LayerPlan(cin, cout, cin_pad, _dz_rp(cin_pad), kc, stage, smem,
                     dz_grid, ri, out_tiles, splits, dw_smem(ri))


def plan_bwd(widths, n_blocks: int, m: int, sms: int,
             limit: int) -> list[LayerPlan] | None:
    """One plan per layer of the chain `widths` (widths[0] is the input's),
    or None where any layer does not fit."""
    plans = [plan_layer(ci, co, n_blocks, m, sms, limit)
             for ci, co in zip(widths[:-1], widths[1:])]
    return None if None in plans else plans


# ---------------------------------------------------------------- forward

FWD_THREADS = 256     # mma::kThreads: 8 warps
FWD_MIN_BLOCKS = 2    # both forward kernels' launch bounds (registers)
MAX_LAYERS = 8        # point_mlp_max.cu kMaxLayers
DENSE_CHUNK = 64      # pmt_dense's output channels at a time (kChunk)
BF16_MMA_MIN_CIN = 16  # point_mlp_max in bf16: a first layer with fewer
                       # input channels runs on the FP32 pipes (kBf16K)


def tile_rows(cin: int, mma_path: bool) -> int:
    """Rows of 64 words of a `cin`-channel activation tile
    (mma::tile_rows): to the K step of 8 on the tensor cores, else 4."""
    return _ceil(cin, 8) * 8 if mma_path else _ceil(cin, 4) * 4


def dense_smem(cin: int, cout: int, stage: bool) -> int:
    """Bytes of a pmt_dense block (csrc: snt_pmt_dense_smem)."""
    return 8 * 2 * cout + 4 * (min(cout, DENSE_CHUNK) * (TILE + 4) + 4 * cin
                               + tile_rows(cin, False) * TILE
                               + (TILE * (cin + 4) if stage else 0))


@dataclass(frozen=True)
class DensePlan:
    cin: int
    cout: int
    stage: bool        # cp.async stages the next tile's rows
    smem: int          # bytes per block
    blocks_per_sm: int  # by shared memory and threads


def plan_dense(cin: int, cout: int, limit: int) -> DensePlan | None:
    """pmt_dense's plan for one layer, or None where the kernel does not
    take it (cout not a multiple of 4, or more shared memory than
    `limit`)."""
    if cin < 1 or cout % 4 or dense_smem(cin, cout, False) > limit:
        return None
    stage = cin % 4 == 0 and blocks_per_sm(
        dense_smem(cin, cout, True), FWD_THREADS, limit) >= FWD_MIN_BLOCKS
    smem = dense_smem(cin, cout, stage)
    return DensePlan(cin, cout, stage, smem,
                     blocks_per_sm(smem, FWD_THREADS, limit))


def pair_rows(c: int) -> int:
    """Rows of 64 words of a `c`-channel tile of bf16 pairs, to the bf16
    K step of 16 channels (mma::pair_rows)."""
    return _ceil(c, BF16_MMA_MIN_CIN) * BF16_MMA_MIN_CIN // 2


def max_rows(widths, bf16: bool = False) -> tuple[int, int]:
    """Rows of point_mlp_max's two tile buffers (csrc: buffer_rows)."""
    if not bf16:
        rows = [tile_rows(widths[0], widths[0] >= 8), 0]
    elif widths[0] < BF16_MMA_MIN_CIN:
        rows = [tile_rows(widths[0], False), 0]
    else:
        rows = [pair_rows(widths[0]), 0]
    for layer in range(1, len(widths) - 1):
        need = pair_rows(widths[layer]) if bf16 \
            else tile_rows(widths[layer], True)
        rows[layer % 2] = max(rows[layer % 2], need)
    return rows[0], rows[1]


def max_smem(widths, bf16: bool = False) -> int:
    """Bytes of a point_mlp_max block (csrc: snt_point_mlp_max_smem)."""
    return 4 * (sum(max_rows(widths, bf16)) * TILE + widths[-1])


@dataclass(frozen=True)
class MaxPlan:
    widths: tuple[int, ...]
    rows: tuple[int, int]
    smem: int
    blocks_per_sm: int


def plan_max(widths, limit: int, bf16: bool = False) -> MaxPlan | None:
    """point_mlp_max's plan for the chain `widths` (widths[0] is the
    input's), with f32 or bf16 operands, or None where the kernel does not
    take it (more than 8 layers, an output width not a multiple of 4, or
    more shared memory than `limit`)."""
    widths = tuple(widths)
    smem = max_smem(widths, bf16)
    if not 1 <= len(widths) - 1 <= MAX_LAYERS or widths[0] < 1 \
            or any(c % 4 for c in widths[1:]) or smem > limit:
        return None
    return MaxPlan(widths, max_rows(widths, bf16), smem,
                   blocks_per_sm(smem, FWD_THREADS, limit))
