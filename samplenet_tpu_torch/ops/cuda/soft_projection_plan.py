"""Launch plans of the soft-projection kernels, forward and backward: pure
Python, so that the CPU tests reach them (csrc/soft_projection.cu; the
constants below are the kernels' own).

The forward kernel serves each query with `slices` adjacent lanes (a
power of two up to MAX_SLICES), which split each group of points it scans
between them. A block of 32 * warps lanes serves one cloud and 32 * warps /
slices of its queries, and stages the cloud in shared memory as float4
(16 bytes a point), `chunk` points at a time: the whole cloud where it
fits in MAX_CHUNK points, staged once for both passes; a longer cloud
chunk by chunk, for each pass. `chunk` is a multiple of 32.

`slices` trades parallelism against merging: the plan takes the fewest
that give the card LANES_PER_SM lanes an SM (30 warps), since every
doubling adds a round of shuffles and insertions to merge the query's
lanes. `warps` is the widest block the cloud's queries fill, up to
MAX_WARPS: a block stages its cloud once for all its queries, and wider
blocks also keep more warps on an SM within its shared memory. PERF.md
has the sweep of slices and warps on an H100 these rules were fitted to
(tools/time_soft_projection.py). The plan depends only on the shape and
the card, and the kernel's outputs do not depend on it.

The backward runs two kernels. The first takes one query a thread over a
flat grid of all B*M queries, `tile` a block (so where M is small a block
serves several clouds), and writes each entry's contribution to the
workspace; its tile is the largest that still gives every SM a block.
The second owns `span` consecutive points of one cloud a block, one to
MAX_PER a thread, and streams the cloud's M*k entries to find its own,
32 * UNROLL a warp a round; a last block a cloud sums d sigma^2. Its grid
is flat, B * (ranges + 1) blocks, so it caps neither B nor N. Every
block of the second kernel reads all of its cloud's entries, and waits on
memory and barriers in each round and slice of its own, so the rules
trade the number of blocks against the entries each reads: span is
SPAN points (fewer where the cloud is smaller), with a thread a point
where the clouds are fewer than the SMs, and four points a thread where
they are not (a block of 64 threads). PERF.md has the sweep of span and
threads on an H100 these rules were fitted to
(tools/time_soft_projection.py). The outputs do not depend on the plan.

Group sizes above MAX_REGISTER_K, and clouds of more queries than the
register forward's grid axis holds, take the wide forward
(`takes_register_fwd`), whose plan (`plan_fwd_wide`) picks one of its two
kernels. The pruned kernel, for k up to PRUNE_MAX_K and at most a quarter
of N: each query's points split over S = ws * cs warp-slices (ws warps of
a block, cs blocks of a thread-block cluster), S the fewest that give the
card FILL_WARPS warps an SM and leave no lane more than MAX_VISITS keys to
cache, while each slice keeps at least 32 * SLOTS points; the blocks of a
cluster before the warps of a block, so that a block's queries share its
staged points, but never more queries a block than the cloud has. G =
max(64, 2k rounded up to a power of two) group minima a query, a buffer of
2G candidates. The radix kernel takes the rest: one warp a query over a
flat grid of all B*M queries, WIDE_WARPS a block, a radix histogram of
RADIX_BINS counters a warp in static shared memory and nothing that grows
with N or k. The outputs do not depend on the plan. The backward takes k
up to MAX_REGISTER_K under the plan above, and any M * k: past
INT_ENTRIES entries a cloud its point kernel counts them in 64 bits.

Above MAX_REGISTER_K the backward runs the wide kernels under
`plan_bwd_wide`: the first a group of `wide_group(k)` lanes a query
(WIDE_GROUP up to k = 64, else a warp), `warps` warps a block (the most up
to WIDE_BWD_WARPS that still give every SM a block); the second `span`
points of a cloud a block (WIDE_POINTS_PER a thread at most), `threads`
threads, reading the cloud's entries in windows of WINDOW_PER * threads
and keeping its own. Its rules: 256 threads where the clouds alone fill
the card, else WIDE_POINT_THREADS (fewer windows, each longer, on the few
clouds); the widest span up to WIDE_SPAN that still gives every SM a
block, down to 32 points. Where the clouds fill the card and a block holds
a cloud's entries and points (`takes_fused`), one fused kernel of a block
a cloud runs both, its contributions in shared memory. The outputs do not
depend on the plan.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_REGISTER_K = 16  # kMaxK: the register kernels' k; above, the wide ones
MAX_WARPS = 8        # kMaxWarps: __launch_bounds__(256)
MAX_SLICES = 8       # kMaxSlices
LANES_PER_SM = 30 * 32
POINT_BYTES = 16     # a staged point: float4 (x, y, z, 0)
MAX_CHUNK = 4096     # points staged at once: 64 KB of shared memory
MAX_GRID_Y = 65535
MAX_GRID_X = 2**31 - 1


@dataclass(frozen=True)
class FwdPlan:
    chunk: int               # points staged at a time, a multiple of 32
    warps: int               # a block has 32 * warps lanes
    slices: int              # lanes a query
    grid: tuple[int, int]    # (clouds, query tiles)

    @property
    def smem(self) -> int:
        return fwd_smem(self.chunk)

    @property
    def tile(self) -> int:
        """Queries a block."""
        return 32 * self.warps // self.slices


def fwd_chunk(n: int) -> int:
    """Points staged at a time for a cloud of n: all of them, rounded up to
    32, up to MAX_CHUNK."""
    return min(-(-n // 32) * 32, MAX_CHUNK)


def fwd_smem(chunk: int) -> int:
    """Shared memory of one block, as the kernel counts it."""
    return chunk * POINT_BYTES


def _fwd_launch(b: int, m: int, sms: int) -> tuple[int, int, int]:
    """(slices, warps, query tiles) of the register forward."""
    slices = 1
    while slices < MAX_SLICES and b * m * slices < sms * LANES_PER_SM:
        slices *= 2
    warps = min(MAX_WARPS, -(-m * slices // 32))
    return slices, warps, -(-m * slices // (32 * warps))


def takes_register_fwd(b: int, m: int, k: int, *, sms: int) -> bool:
    """Whether the register forward takes the shape: k up to
    MAX_REGISTER_K and its query tiles within a grid axis (M up to
    16,776,960 a cloud). The wide forward takes the rest."""
    return k <= MAX_REGISTER_K and _fwd_launch(b, m, sms)[2] <= MAX_GRID_Y


def plan_fwd(b: int, n: int, m: int, *, sms: int) -> FwdPlan:
    """The plan for B clouds of n points and m queries each on a card of
    `sms` SMs."""
    if min(b, n, m, sms) < 1:
        raise ValueError(f"plan_fwd needs positive sizes, got b={b}, n={n}, "
                         f"m={m}, sms={sms}")
    slices, warps, grid_y = _fwd_launch(b, m, sms)
    if grid_y > MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    return FwdPlan(chunk=fwd_chunk(n), warps=warps, slices=slices,
                   grid=(b, grid_y))


WIDE_WARPS = 8       # kWideWarps: queries a block of the radix kernel
RADIX_BINS = 256     # kRadixBins: 8 bits a pass
PRUNE_WARPS = 8      # kPruneWarps: a pruned block's warps
SLOTS = 8            # kSlots: group minima a lane keeps
MAX_GROUPS = 128     # kMaxGroups
MAX_CAP = 256        # kMaxCap
MAX_CLUSTER = 8      # kMaxCluster: the portable cluster size
MAX_VISITS = 64      # kMaxVisits: keys a lane caches
PRUNE_CHUNK = 2048   # kMaxPruneChunk: points staged at a time
PRUNE_MAX_K = 64
FILL_WARPS = 16      # warps an SM that the pruned split aims for


@dataclass(frozen=True)
class WideFwdPlan:
    ws: int          # warps a query in a block; 0: the radix kernel
    cs: int          # blocks a cluster, each `span` points of the cloud
    groups: int      # group minima a query (G)
    cap: int         # candidates a query
    chunk: int       # points staged at a time
    span: int        # points a block
    grid: int        # blocks

    @property
    def radix(self) -> bool:
        return self.ws == 0

    @property
    def split(self) -> int:
        """Warp-slices a query: S = ws * cs."""
        return self.ws * self.cs

    @property
    def queries(self) -> int:
        """Queries a block (a cluster)."""
        return WIDE_WARPS if self.radix else PRUNE_WARPS // self.ws

    @property
    def visits(self) -> int:
        """Keys a lane caches: every visit of the block's chunks."""
        return -(-self.span // self.chunk) * self.chunk // (32 * self.ws)

    @property
    def smem(self) -> int:
        """Shared memory of a block, as the kernels count it: the radix
        kernel's static histograms, or the pruned kernel's dynamic layout
        (the staged chunks, which the queries' states reuse, then the
        warps' key caches)."""
        if self.radix:
            return wide_smem(WIDE_WARPS)
        staged = (2 if self.span > self.chunk else 1) * self.chunk * 16
        states = self.queries * (self.cap * 8 + 16)
        return max(staged, states) + PRUNE_WARPS * 32 * self.visits * 4


def wide_smem(warps: int) -> int:
    return warps * RADIX_BINS * 4


def _pow2(v: int) -> int:
    return 1 << max(0, v - 1).bit_length()


def pruned_split(b: int, n: int, m: int, *, sms: int) -> int:
    """S, the warp-slices a query of the pruned kernel (a power of two up
    to 64): the fewest that give the card FILL_WARPS warps an SM and no
    lane more than MAX_VISITS keys, each slice keeping 32 * SLOTS points."""
    s = 1
    while s < PRUNE_WARPS * MAX_CLUSTER and (
            b * m * s < sms * FILL_WARPS or -(-n // s) > 32 * MAX_VISITS) \
            and -(-n // (2 * s)) >= 32 * SLOTS:
        s *= 2
    return s


def plan_fwd_wide(b: int, n: int, m: int, k: int, *, sms: int) -> WideFwdPlan:
    """The wide forward's plan for B clouds of n points and m queries, any
    1 <= k <= n, on a card of `sms` SMs."""
    if min(b, n, m, k, sms) < 1 or k > n:
        raise ValueError(f"plan_fwd_wide needs positive sizes and k <= n, "
                         f"got b={b}, n={n}, m={m}, k={k}, sms={sms}")
    s = pruned_split(b, n, m, sms=sms)
    if k > PRUNE_MAX_K or 4 * k > n or -(-n // s) > 32 * MAX_VISITS:
        grid = -(-b * m // WIDE_WARPS)
        if grid > MAX_GRID_X:
            raise ValueError(f"B={b} x M={m} queries exceed the wide "
                             f"kernel's grid")
        return WideFwdPlan(0, 1, 0, 0, 0, 0, grid)
    cs = min(MAX_CLUSTER, s)
    ws = s // cs
    while cs > 1 and PRUNE_WARPS // ws > m:    # queries a block the cloud has
        cs //= 2
        ws *= 2
    return pruned_plan(b, n, m, k, ws, cs)


def pruned_plan(b: int, n: int, m: int, k: int, ws: int, cs: int
                ) -> WideFwdPlan:
    """The pruned kernel's plan at the split (ws, cs): G = max(64, 2k
    rounded up to a power of two), a buffer of 2G candidates, a block's
    span its share of the cloud rounded up to 32 * ws points, and the
    chunk the smallest multiple of 256 * ws (whole batches of 8 visits a
    lane) that holds the span, up to PRUNE_CHUNK points. A split that
    leaves a block no points is refused."""
    groups = max(64, _pow2(2 * k))
    span = -(-n // (cs * 32 * ws)) * 32 * ws
    chunk = min(-(-span // (256 * ws)) * 256 * ws, max(PRUNE_CHUNK, 256 * ws))
    grid = b * -(-m // (PRUNE_WARPS // ws)) * cs
    plan = WideFwdPlan(ws, cs, groups, 2 * groups, chunk, span, grid)
    if (groups > MAX_GROUPS or ws * cs > groups or plan.visits > MAX_VISITS
            or ws not in (1, 2, 4, 8) or cs not in (1, 2, 4, 8)
            or (cs - 1) * span >= n):
        raise ValueError(f"the pruned kernel does not take k={k}, n={n} at "
                         f"ws={ws}, cs={cs}")
    if grid > MAX_GRID_X:
        raise ValueError(f"B={b} x M={m} queries exceed the wide kernel's "
                         f"grid")
    return plan


# the backward: soft_project_bwd_entries and soft_project_bwd_points
MAX_TILE = 256           # kMaxTile: queries a block of the first kernel
MAX_POINT_THREADS = 256  # kMaxPointThreads
MAX_PER = 4              # kMaxPer: points a thread
UNROLL = 4               # kUnroll: idx loads a lane holds a round
STRIPES = 256            # kStripes: d sigma^2's query stripes
SPAN = 256               # points a point block owns, at most
# entries (M * k) a cloud the point kernel counts in int; past them, in
# 64 bits (kIntEntries)
INT_ENTRIES = 2**31 - 1 - 32 * UNROLL * MAX_POINT_THREADS


@dataclass(frozen=True)
class BwdPlan:
    tile: int       # queries a block of the first kernel, one a thread
    threads: int    # a point block's threads
    span: int       # points a point block owns, a multiple of threads
    count64: bool = False   # the point kernel counts entries in 64 bits


def counts_in_64_bits(m: int, k: int) -> bool:
    """Whether the register point kernel must count a cloud's M * k
    entries in 64 bits (soft_project_bwd_points64); a plan may ask for it
    at any size (the same sums in the same order). The wide point kernel
    numbers its windows in 64 bits at every size."""
    return m * k > INT_ENTRIES


def bwd_smem(threads: int, span: int, entries: int) -> int:
    """Dynamic shared memory of a point block, as the kernel counts it: the
    [span] hit flags and [warps, span] lane masks, then the larger of a
    round's list (a float4 contribution and a point each, at most
    min(round, entries) of them) and the block's staged rows of d points."""
    warps = threads // 32
    cap = min(32 * UNROLL * warps, entries)
    return (warps + 1) * span * 4 + max(cap * 20, span * 12)


def plan_bwd(b: int, n: int, m: int, k: int, *, sms: int) -> BwdPlan:
    """The backward's plan for B clouds of n points, m queries and k
    neighbours each, on a card of `sms` SMs."""
    if min(b, n, m, k, sms) < 1:
        raise ValueError(f"plan_bwd needs positive sizes, got b={b}, n={n}, "
                         f"m={m}, k={k}, sms={sms}")
    tile = MAX_TILE
    while tile > 32 and -(-b * m // tile) < sms:
        tile //= 2
    span = min(SPAN, max(32, 1 << (n - 1).bit_length()))
    threads = span if b < sms else max(32, span // MAX_PER)
    if (-(-b * m // tile) > MAX_GRID_X
            or b * (-(-n // span) + 1) > MAX_GRID_X):
        raise ValueError(f"B={b}, N={n}, M={m}, k={k} exceed the kernels' "
                         f"grids")
    return BwdPlan(tile=tile, threads=threads, span=span,
                   count64=counts_in_64_bits(m, k))


# the wide backward (k > MAX_REGISTER_K): soft_project_bwd_entries_warp and
# soft_project_bwd_points_wide
WIDE_BWD_WARPS = 8          # kWideBwdWarps: warps a block, most
WIDE_RANKS = 8              # kWideRanks: ranks a lane holds in registers
WIDE_GROUP = 8              # kWideGroup: lanes a query up to k = 64
WIDE_POINT_THREADS = 1024   # kWidePointThreads: a point block's most
WIDE_SPAN = 4096            # kWideSpan: points a point block owns, most
WINDOW_PER = 4              # kWindowPer: entries a thread a window
WIDE_POINTS_PER = 4         # kWidePointsPer: points a thread of a point block
FUSED_ENTRIES = 4096        # kFusedEntries: the fused kernel's M*k, most
FUSED_THREADS = 256         # the fused kernel's block (kWideBwdWarps warps)
MIN_WIDE_SPAN = 32


def wide_group(k: int) -> int:
    """Lanes a query of the wide backward's first kernel: WIDE_GROUP up to
    k = WIDE_RANKS * WIDE_GROUP, else a warp (k alone sets it, and with it
    the order of the query's sums)."""
    return WIDE_GROUP if k <= WIDE_RANKS * WIDE_GROUP else 32


@dataclass(frozen=True)
class WideBwdPlan:
    warps: int      # warps a block of the first kernel
    threads: int    # a point block's threads (fused: the one kernel's)
    span: int       # points a point block owns
    fused: bool = False  # one kernel, a block a cloud (warps, span unused)

    @property
    def smem(self) -> int:
        return wide_bwd_smem(self.threads, self.span)

    def grids(self, b: int, n: int, m: int, k: int) -> tuple[int, int]:
        """Blocks of the two kernels: the first's over all B*M queries,
        32 / wide_group(k) a warp, the point kernel's B * point ranges
        (fused: B blocks, and no second kernel)."""
        if self.fused:
            return b, 0
        per_block = self.warps * (32 // wide_group(k))
        return -(-b * m // per_block), b * -(-n // self.span)


def fused_bwd_smem(n: int, m: int, k: int) -> int:
    """Dynamic shared memory of a fused wide backward block: the cloud's M*k
    contributions (float4), each one's point and the list (ints), its
    queries' d sigma^2 terms (double), the offsets [n + 1] and cursors
    [n]."""
    return m * k * 24 + 8 * m + 4 * (2 * n + 1)


def takes_fused(b: int, n: int, m: int, k: int, *, sms: int) -> bool:
    """Whether the fused kernel takes the shape: the clouds fill the card,
    a cloud's entries fit FUSED_ENTRIES and its points WIDE_POINTS_PER a
    thread of a FUSED_THREADS block."""
    return (b >= sms and m * k <= FUSED_ENTRIES
            and n <= WIDE_POINTS_PER * FUSED_THREADS)


def wide_bwd_smem(threads: int, span: int) -> int:
    """Dynamic shared memory of a wide point block, as the kernel counts
    it: a window's WINDOW_PER * threads contributions (float4) and list,
    then the span's offsets [span + 1] and cursors [span]."""
    return WINDOW_PER * threads * 20 + 4 * (2 * span + 1)


def plan_bwd_wide(b: int, n: int, m: int, k: int, *, sms: int
                  ) -> WideBwdPlan:
    """The wide backward's plan for B clouds of n points, m queries and k
    neighbours each, on a card of `sms` SMs (k moves only the choice of
    the fused kernel)."""
    if min(b, n, m, k, sms) < 1:
        raise ValueError(f"plan_bwd_wide needs positive sizes, got b={b}, "
                         f"n={n}, m={m}, k={k}, sms={sms}")
    warps = WIDE_BWD_WARPS
    while warps > 1 and -(-b * m // warps) < sms:
        warps //= 2
    threads = 256 if b >= sms else WIDE_POINT_THREADS
    span = min(WIDE_SPAN, WIDE_POINTS_PER * threads,
               max(MIN_WIDE_SPAN, 1 << (n - 1).bit_length()))
    while span > MIN_WIDE_SPAN and b * -(-n // span) < sms:
        span //= 2
    if takes_fused(b, n, m, k, sms=sms):
        plan = WideBwdPlan(warps=WIDE_BWD_WARPS, threads=FUSED_THREADS,
                           span=span, fused=True)
    else:
        plan = WideBwdPlan(warps=warps, threads=threads, span=span)
    if max(plan.grids(b, n, m, k)) > MAX_GRID_X:
        raise ValueError(f"B={b}, N={n}, M={m}, k={k} exceed the wide "
                         f"backward's grids")
    return plan
