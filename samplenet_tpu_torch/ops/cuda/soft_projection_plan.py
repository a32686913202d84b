"""Launch plan of the soft-projection forward kernel: pure Python, so that
the CPU tests reach it (csrc/soft_projection.cu; the constants below are
the kernel's own).

The kernel serves each query with `slices` adjacent lanes (a power of two
up to MAX_SLICES), which split each group of points it scans between
them. A block of 32 * warps lanes serves one cloud and 32 * warps /
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
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_WARPS = 8        # kMaxWarps: __launch_bounds__(256)
MAX_SLICES = 8       # kMaxSlices
LANES_PER_SM = 30 * 32
POINT_BYTES = 16     # a staged point: float4 (x, y, z, 0)
MAX_CHUNK = 4096     # points staged at once: 64 KB of shared memory
MAX_GRID_Y = 65535


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


def plan_fwd(b: int, n: int, m: int, *, sms: int) -> FwdPlan:
    """The plan for B clouds of n points and m queries each on a card of
    `sms` SMs."""
    if min(b, n, m, sms) < 1:
        raise ValueError(f"plan_fwd needs positive sizes, got b={b}, n={n}, "
                         f"m={m}, sms={sms}")
    slices = 1
    while slices < MAX_SLICES and b * m * slices < sms * LANES_PER_SM:
        slices *= 2
    warps = min(MAX_WARPS, -(-m * slices // 32))
    grid_y = -(-m * slices // (32 * warps))
    if grid_y > MAX_GRID_Y:
        raise ValueError(f"M={m} exceeds the kernel's grid")
    return FwdPlan(chunk=fwd_chunk(n), warps=warps, slices=slices,
                   grid=(b, grid_y))
