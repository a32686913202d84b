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
  channels runs on the FP32 pipes and keeps x in f32 rows. Where the B
  clouds alone do not fill the card's block slots, a cloud's tiles are
  split over S blocks (`max_splits`), which fold their maxima into the
  output; the output does not depend on S.

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
  Where none of those layouts fits (the tile's dz [cout, 68] and the
  constants [7, cout] alone pass the card's limit from cout = 768 on at
  cin 128), the layer is chunked: `dz_oc` < cout output channels at a
  time, each chunk's constants, dz [dz_oc, 68] and op(W)^T rows
  [dz_oc, cin_pad] (`dz_kc` = `dz_oc`) in shared memory, formed and
  multiplied in increasing order, each thread's dh_prev partial carried
  from chunk to chunk (in registers where the tile's dh_prev takes one
  pass of the block's threads, else in dh_prev itself in HBM, which the
  same thread wrote and reads back). Every partial goes on with the next
  o, as in one chunk, so dz and dh_prev do not depend on `dz_oc`.
- `pmt_bwd_dw` computes dW = op(act(h_prev))^T dz by split-K over the 64-
  point tiles: a grid of (output tiles of [cin_pad, cout]: 64 input x 64
  output channels at `dw_ri` = 4, 64 x 128 at 8) x `dw_splits` runs of
  consecutive tiles. Each tile is summed in f32, the tiles of a run in f64
  registers, and the runs' f64 partials by the caller in a fixed order;
  `dw_splits` depends only on the shape and the SM count, so the bits
  repeat from run to run.

With bf16 operands (backward modes 1 and 2, and the bf16 forward) the
passes run on the tensor cores (mma.sync m16n8k16), but for pmt_bwd_dz in
the ghost chain's mode 1 (`dz_bf16=False`), and their layouts
(`bf16=True`) hold bf16 pairs: pmt_dense's tile two channels a word
(`pair_rows`, but for a layer of fewer than 16 input channels, which
stays on the FP32 pipes); pmt_bwd_dz's op(W)^T as [pair_rows(kc),
wt_stride(cin_pad)] words, K chunks a multiple of the K step of 16
(`kc` = cout where it stays whole); pmt_bwd_dw's raw tiles staged once
([64, 68] of act(h_prev), [64, dw_to + 4] of dz) beside their transformed
copies in point pairs ([64 + dw_to, 36] words) and the tile's BN
constants. The chunked pmt_bwd_dz stays on the FP32 pipes in every mode,
with its f32 layout.

Output widths that are not multiples of 4 are planned at the next
multiple of 4 (`kernel_widths`): the wrappers pad the layer with zero
weight columns and bias, and BN's gamma = beta = 0, so that a padded
channel's z and h are 0 and its gradients are dropped.

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


def pad4(c: int) -> int:
    """A width rounded up to the kernels' multiple of 4."""
    return -(-c // 4) * 4


def kernel_widths(widths) -> tuple[int, ...]:
    """The widths a chain's kernels run: each output width rounded up to
    a multiple of 4, the input's as it is."""
    return (widths[0], *(pad4(c) for c in widths[1:]))


def dw_to(ri: int) -> int:
    """Output channels of a dW output tile (dw_to<kRI>)."""
    return DW_THREADS * ri * 8 // DW_TILE


def dw_ri(cout: int) -> int:
    """Input channels a dW thread owns (x 8 output channels): 8 where cout
    fills the 128-wide output tile that takes (4 FMA per float read from
    shared memory, against 2.7 at 4 x 8), else 4."""
    return 8 if cout >= dw_to(8) else 4


PAIR_STRIDE = 36      # pmt_bwd_dw in bf16: words a row of point pairs


def dw_smem(ri: int, bf16: bool = False) -> int:
    """Two stages of a 64-point tile of act(h_prev), 64 channels, and of
    dz, dw_to(ri) channels; in bf16 one stage of each (rows padded by 4),
    op(act(h_prev)) in point pairs [64, 36] words and the BN constants
    [4, 64] (snt_pmt_bwd_dw_smem)."""
    if bf16:
        return 4 * (TILE * (DW_TILE + 4 + dw_to(ri) + 4)
                    + DW_TILE * PAIR_STRIDE + 4 * DW_TILE)
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
    dz_oc: int        # output channels of dz a chunk (cout: one chunk)
    dz_smem: int      # bytes per block
    dz_grid: int
    dw_ri: int
    dw_out_tiles: int
    dw_splits: int
    dw_smem: int
    bf16: bool = False  # the bf16 layout of pmt_bwd_dw (on the tensor cores)
    dz_blocks: int = 2  # pmt_bwd_dz_mma: the blocks an SM its build is for
    top: bool = False   # the chain's top layer (its dh: the pooled cotangent)
    dz_mma: bool = False  # pmt_bwd_dz_mma's layout (bf16, unchunked)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


def wt_stride(cin_pad: int) -> int:
    """Words a row of op(W)^T pairs takes in a bf16 pmt_bwd_dz block:
    cin_pad to the MMA's N step of 8, plus 8 where that is a multiple of
    16, so that a B fragment's rows start 8 or 24 banks apart."""
    n8 = _ceil(cin_pad, 8) * 8
    return n8 + (8 if n8 % 16 == 0 else 0)


def stage_sets(stage: bool, bf16: bool, top: bool) -> int:
    """Row sets a pmt_bwd_dz block stages a point (its `stage` argument in
    bf16): z and dh, or in bf16 for a top layer z alone (the pooled
    cotangent stands for dh there)."""
    return int(stage) * (1 if bf16 and top else 2)


def dz_smem(cin_pad: int, cout: int, kc: int, stage: bool,
            oc: int | None = None, bf16: bool = False,
            top: bool = False) -> int:
    """Bytes of a pmt_bwd_dz block (csrc: snt_pmt_bwd_dz_smem): op(W)^T
    rows [kc, cin_pad] (in bf16, unchunked: [pair_rows(kc),
    wt_stride(cin_pad)] words of pairs), 7 per-channel constants and dz
    channel-major [oc, 68] for a chunk of `oc` output channels (all cout
    by default), each point's cloud and index [2, 64], and with `stage`
    the raw z and dh rows [2, 64, cout] (in bf16 for a `top` layer z
    alone, [64, cout])."""
    oc = cout if oc is None else oc
    pairs = bf16 and oc == cout
    wt = pair_rows(kc) * wt_stride(cin_pad) if pairs else kc * cin_pad
    return 4 * (wt + 7 * oc + oc * (TILE + 4) + 2 * TILE
                + stage_sets(stage, pairs, top) * TILE * cout)


def blocks_per_sm(smem: int, threads: int,
                  limit: int = 232448) -> int:
    """Resident blocks per SM by shared memory and threads: an SM holds
    the per-block limit plus one reservation."""
    by_smem = (limit + SMEM_RESERVED) // (smem + SMEM_RESERVED)
    return max(0, min(by_smem, MAX_THREADS_PER_SM // threads))


def _fit(room: int, n: int, least: int, cap: int | None = None):
    """The fewest equal chunks, multiples of 4, of n channels at most
    `room` (and `cap`) wide: their width, or None under `least`."""
    most = min(n, room, n if cap is None else cap) // 4 * 4
    if most < max(4, least):
        return None
    return min(most, _ceil(_ceil(n, _ceil(n, most)), 4) * 4)


K_STEP = 16           # mma.sync m16n8k16's K (mma::kBf16K)


def _fit_pairs(room: int, cin_pad: int, cout: int, least: int):
    """bf16: channels of op(W)^T a block holds in `room` bytes, cout where
    all its pair rows fit, else the fewest equal K chunks, multiples of
    the K step of 16 and at least `least` (None where none fits)."""
    per_step = 4 * (K_STEP // 2) * wt_stride(cin_pad)
    if room >= per_step * _ceil(cout, K_STEP):
        return cout
    most = max(room, 0) // per_step * K_STEP
    if least >= cout or most < max(K_STEP, least):
        return None
    return _ceil(_ceil(cout, _ceil(cout, most)), K_STEP) * K_STEP


def _dz_layout(cin_pad: int, cout: int, limit: int,
               oc_cap: int | None = None, bf16: bool = False,
               top: bool = False):
    """(kc, stage, oc) for pmt_bwd_dz, the first that fits of: two blocks
    to an SM with op(W)^T whole and the rows staged; the same unstaged;
    two blocks with K chunks of at least 32 rows, unstaged; one block with
    chunks of at least 4 rows, staged, then unstaged (oc = cout: dz
    whole); then the chunked layout, two blocks to an SM with chunks of at
    least 32 output channels, then one with at least 4 (kc = oc, at most
    `oc_cap` where given). Chunks are the fewest equal multiples of 4
    that fit. In bf16 the K chunks of op(W)^T pairs are multiples of 16,
    and the staged layouts come first, with K chunks where op(W)^T does
    not fit whole beside the staged rows: the form's reads of z and dh
    bound pmt_bwd_dz_mma, and the stage puts a whole tile's in flight (a
    `top` layer stages z alone). The chunked layout is the f32 one."""
    half = (limit + SMEM_RESERVED) // 2 - SMEM_RESERVED
    order = ((half, True, cout), (half, False, cout),
             (half, False, min(cout, 32)), (limit, True, 4),
             (limit, False, 4))
    if bf16:
        order = ((half, True, cout), (half, True, K_STEP)) + order[1:]
    for budget, stage, kc_min in order:
        if bf16:
            kc = _fit_pairs(budget - dz_smem(cin_pad, cout, 0, stage,
                                             bf16=True, top=top),
                            cin_pad, cout, kc_min)
        else:
            room = (budget - dz_smem(cin_pad, cout, 0, stage)) \
                // (4 * cin_pad)
            kc = _fit(room, cout, kc_min)
        if kc is not None:
            return kc, stage, cout
    per_channel = dz_smem(cin_pad, 1, 1, False, 1) - dz_smem(cin_pad, 0, 0,
                                                             False, 0)
    for budget, oc_min in ((half, 32), (limit, 4)):
        room = (budget - dz_smem(cin_pad, 0, 0, False, 0)) // per_channel
        oc = _fit(room, cout, min(cout, oc_min), oc_cap)
        if oc is not None and oc < cout:
            return oc, False, oc
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
               limit: int, oc_cap: int | None = None,
               bf16: bool = False, top: bool = False,
               dz_bf16: bool | None = None) -> LayerPlan | None:
    """The plan of one layer for `n_blocks` ghost blocks of `m` points
    each, on a card with `sms` SMs and `limit` bytes of shared memory per
    block, in the bf16 layouts where `bf16` (pmt_bwd_dz's where `dz_bf16`,
    `bf16` by default; `top`: the chain's top layer, `_dz_layout`); None
    where a pass does not fit. cout is planned at
    `pad4`; a chunked layer takes chunks of at most `oc_cap` output
    channels where given (the others ignore it). The grids are the f32
    plan's but for pmt_bwd_dz's, which follows its shared memory;
    pmt_bwd_dz_mma is built for three blocks an SM where three fit and
    the layer has 16 or more input channels (measured faster there, and
    slower at the 4 of layer 0, on the H100), else two."""
    cin_pad, cout = pad4(cin), pad4(cout)
    dz_bf16 = bf16 if dz_bf16 is None else dz_bf16
    layout = _dz_layout(cin_pad, cout, limit, oc_cap, True, top) if dz_bf16 \
        else _dz_layout(cin_pad, cout, limit, oc_cap)
    ri = dw_ri(cout)
    if layout is None or dw_smem(ri, bf16) > limit:
        return None
    kc, stage, oc = layout
    smem = dz_smem(cin_pad, cout, kc, stage, oc, dz_bf16, top)
    tiles = n_blocks * _ceil(m, TILE)
    dz_grid = max(1, min(tiles, blocks_per_sm(smem, DZ_THREADS, limit) * sms))
    out_tiles = _ceil(cin_pad, DW_TILE) * _ceil(cout, dw_to(ri))
    splits = max(1, min(tiles, _ceil(DW_BLOCKS_PER_SM[ri] * sms, out_tiles)))
    mma = dz_bf16 and oc == cout
    three = mma and cin_pad >= K_STEP \
        and blocks_per_sm(smem, DZ_THREADS, limit) >= 3
    return LayerPlan(cin, cout, cin_pad, _dz_rp(cin_pad), kc, stage, oc,
                     smem, dz_grid, ri, out_tiles, splits, dw_smem(ri, bf16),
                     bf16, 3 if three else 2, top, mma)


def plan_bwd(widths, n_blocks: int, m: int, sms: int, limit: int,
             oc_cap: int | None = None, bf16: bool = False,
             dz_bf16: bool | None = None) -> list[LayerPlan] | None:
    """One plan per layer of the chain `widths` (widths[0] is the input's;
    the kernels run `kernel_widths(widths)`), or None where any layer does
    not fit; `oc_cap`, `bf16` and `dz_bf16` as in `plan_layer`, the last
    layer the top one."""
    widths = kernel_widths(widths)
    pairs = list(zip(widths[:-1], widths[1:]))
    plans = [plan_layer(ci, co, n_blocks, m, sms, limit, oc_cap, bf16,
                        i == len(pairs) - 1, dz_bf16)
             for i, (ci, co) in enumerate(pairs)]
    return None if None in plans else plans


# ---------------------------------------------------------------- forward

FWD_THREADS = 256     # mma::kThreads: 8 warps
FWD_MIN_BLOCKS = 2    # both forward kernels' launch bounds (registers)
PARAM_LAYERS = 8      # point_mlp_max.cu kMaxLayers: deeper chains read their
                      # layer table from device memory
DENSE_CHUNK = 64      # pmt_dense's output channels at a time (kChunk)
BF16_MMA_MIN_CIN = 16  # point_mlp_max in bf16: a first layer with fewer
                       # input channels runs on the FP32 pipes (kBf16K)


def tile_rows(cin: int, mma_path: bool) -> int:
    """Rows of 64 words of a `cin`-channel activation tile
    (mma::tile_rows): to the K step of 8 on the tensor cores, else 4."""
    return _ceil(cin, 8) * 8 if mma_path else _ceil(cin, 4) * 4


def dense_rows(cin: int, bf16: bool = False) -> int:
    """Rows of pmt_dense's activation tile: bf16 pairs (`pair_rows`) where
    the layer runs on the tensor cores (bf16 and 16 or more input
    channels), else f32 rows to 4 (the FP32 pipes)."""
    if bf16 and cin >= BF16_MMA_MIN_CIN:
        return pair_rows(cin)
    return tile_rows(cin, False)


def dense_smem(cin: int, cout: int, stage: bool, bf16: bool = False,
               w_smem: bool = False) -> int:
    """Bytes of a pmt_dense block (csrc: snt_pmt_dense_smem, its bf16
    argument 2 with `w_smem`); on the tensor cores with `w_smem` also
    op(W)'s pairs [pair_rows(cin), wt_stride(cout)] words."""
    mma = bf16 and w_smem and cin >= BF16_MMA_MIN_CIN
    return 8 * 2 * cout + 4 * (min(cout, DENSE_CHUNK) * (TILE + 4) + 4 * cin
                               + dense_rows(cin, bf16) * TILE
                               + (TILE * (cin + 4) if stage else 0)
                               + (pair_rows(cin) * wt_stride(cout)
                                  if mma else 0))


@dataclass(frozen=True)
class DensePlan:
    cin: int
    cout: int
    stage: bool        # cp.async stages the next tile's rows
    smem: int          # bytes per block
    blocks_per_sm: int  # by shared memory and threads
    bf16: bool = False  # bf16 operands (pairs where cin >= 16)
    w_smem: bool = False  # bf16: op(W)'s pairs in shared memory


def plan_dense(cin: int, cout: int, limit: int,
               bf16: bool = False) -> DensePlan | None:
    """pmt_dense's plan for one layer of `cin` input channels as the
    kernel reads them and cout planned at `pad4`, with bf16 operands where
    `bf16`, or None where it needs more shared memory than `limit`."""
    cout = pad4(cout)
    if cin < 1 or dense_smem(cin, cout, False, bf16) > limit:
        return None
    # on the tensor cores op(W) goes to shared memory where two blocks
    # still fit an SM with it (beside it the L1 keeps too little of W)
    w_smem = bf16 and cin >= BF16_MMA_MIN_CIN and blocks_per_sm(
        dense_smem(cin, cout, False, bf16, True), FWD_THREADS,
        limit) >= FWD_MIN_BLOCKS
    stage = cin % 4 == 0 and blocks_per_sm(
        dense_smem(cin, cout, True, bf16, w_smem), FWD_THREADS,
        limit) >= FWD_MIN_BLOCKS
    smem = dense_smem(cin, cout, stage, bf16, w_smem)
    return DensePlan(cin, cout, stage, smem,
                     blocks_per_sm(smem, FWD_THREADS, limit), bf16, w_smem)


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
    input's), with f32 or bf16 operands, at `kernel_widths(widths)`, or
    None where the kernel does not take it: more shared memory than
    `limit`, the only bound, as VMEM is the TPU kernel's (any number of
    layers)."""
    widths = kernel_widths(widths)
    smem = max_smem(widths, bf16)
    if len(widths) < 2 or widths[0] < 1 or smem > limit:
        return None
    return MaxPlan(widths, max_rows(widths, bf16), smem,
                   blocks_per_sm(smem, FWD_THREADS, limit))


# point_mlp_max's split: blocks a cloud where B alone leaves block slots idle
SPLIT_BLOCK_COST = 0.25  # a block's own work (zeroing, the fold), in tiles
MAX_SPLITS = 65535       # the grid's y axis


def max_splits(b: int, n: int, *, sms: int, resident: int) -> int:
    """S, the blocks point_mlp_max gives each of B clouds of n points on a
    card of `sms` SMs holding `resident` of its blocks each: 1 where the
    clouds alone fill those slots, as the kernel ran before it split
    (B=1024 at the eval shape); else the S, 1 to the cloud's 64-point
    tiles, whose blocks finish first, each walking ceil(tiles / S) tiles
    plus its own work (SPLIT_BLOCK_COST), in waves of the card's slots;
    the fewest on a tie."""
    if min(b, n, sms, resident) < 1:
        raise ValueError(f"max_splits needs positive sizes, got b={b}, "
                         f"n={n}, sms={sms}, resident={resident}")
    slots = sms * resident
    if b >= slots:
        return 1
    tiles = _ceil(n, TILE)
    best, best_cost = 1, None
    for s in range(1, min(tiles, slots, MAX_SPLITS) + 1):
        cost = _ceil(b * s, slots) * (_ceil(tiles, s) + SPLIT_BLOCK_COST)
        if best_cost is None or cost < best_cost:
            best, best_cost = s, cost
    return best
