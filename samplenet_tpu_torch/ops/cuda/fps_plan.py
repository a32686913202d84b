"""Launch plan of the seeded-FPS kernel: pure Python, so that the CPU tests
reach it (csrc/fps.cu; the constants below are the kernel's own).

The kernel runs one block of `warps` warps a cloud. Thread t of its T
threads holds `points` (R) points of the cloud, t, t + T, ..., in
registers with their running distances; R is one of REG_POINTS, and the
registers cap the block at `max_threads(R)`. A cloud longer than the
widest block can hold that way takes the `shared` variant: R =
SHARED_POINTS distances a thread, each point's xyz reread from shared
memory every step. Every block stages the whole cloud in shared memory
(12 bytes a point), which caps N.

The plan spreads a cloud over more warps, up to PLAN_WARPS and one a 32
points, while the batch leaves the card short of WARPS_PER_SM warps an SM
(two warps a cloud at B=1024 on 132 SMs, eight at B=50), then takes the
fewest points a thread that hold the cloud. PERF.md has the sweep of
warps and points on an H100 these rules were fitted to
(tools/time_fps.py). The kernel's outputs do not depend on the plan.

Where no such plan fits (N above 16,384, or the cloud and the picks beyond
a block's shared memory), the cluster variant takes the cloud: C blocks of
CLUSTER_THREADS a cloud (C in CLUSTER_SIZES, one thread-block cluster
where C > 1), each staging its slice of the cloud (CLUSTER_THREADS * R
points, 12 bytes each) in shared memory and holding R running distances a
thread in registers, R the fewest of CLUSTER_POINTS that hold the cloud.
`plan_cluster` takes the C whose launch runs in the fewest waves of the
clouds the card holds at once (on the card cudaOccupancyMaxActiveClusters
of each build, `active`; the default is one block an SM, a cluster of C
taking C SMs), then the smallest C: its exchange a pick costs least.
Where no C holds the cloud in its slices (more than 131,072 points),
`stream`: C = STREAM_CLUSTER (a non-portable cluster of 16: each pick
rereads the cloud from L2, so the more SMs the less each reads), the
running distances in a [B, N] workspace in device memory and the xyz
read from it every step. k costs it no
shared memory; every cloud it gets has 7,000 points or more. Only int32
indexing caps N.
"""

from __future__ import annotations

from dataclasses import dataclass

MAX_WARPS = 32                      # kMaxWarps: 1024 threads
REG_POINTS = (1, 2, 4, 8, 16, 32)   # the kernels' R with xyz held
SHARED_POINTS = 16                  # kSharedPoints
PLAN_WARPS = 8                      # the widest block the plan picks
WARPS_PER_SM = 12
SLOT_BYTES = 2 * MAX_WARPS * 8      # two rows of (bits, index) a warp
# the cluster variant (fps_cluster_kernel)
CLUSTER_SIZES = (1, 2, 4, 8)        # its builds' C: blocks a cloud
STREAM_CLUSTER = 16                 # kStreamCluster: C of the streamed build
CLUSTER_THREADS = 1024              # kClusterThreads
GIVEN_CHUNK = 256                   # kGivenChunk: given points staged at once
CLUSTER_POINTS = (1, 2, 4, 8, 16)   # its R with the slice in shared memory
MAX_POINTS = 2**31 - 1              # int32 indexing


@dataclass(frozen=True)
class FpsPlan:
    warps: int       # a block has 32 * warps threads
    points: int      # R, points a thread (cluster variant: 0 streamed)
    shared: bool     # xyz reread from shared memory every step
    cluster: int = 0        # C of the cluster variant; 0: one block a cloud

    @property
    def threads(self) -> int:
        return 32 * self.warps

    @property
    def stream(self) -> bool:
        """The cluster variant with the distances in device memory."""
        return self.cluster > 0 and self.points == 0

    @property
    def capacity(self) -> int:
        """Points a block holds (a cluster in the cluster variant; the
        streamed variant holds any cloud)."""
        if self.stream:
            return MAX_POINTS
        return self.threads * self.points * max(self.cluster, 1)


def max_threads(points: int, shared: bool) -> int:
    """The widest block of the kernel with `points` a thread, as its
    __launch_bounds__ say."""
    if shared:
        return 1024
    return 256 if points >= 32 else (512 if points >= 16 else 1024)


def fps_smem(n: int, k: int) -> int:
    """Shared memory of one block, as the kernel counts it: the warps'
    slots, the cloud (3n floats, padded to 16 bytes), the given points'
    xyz (float4 each) and the picks (int32 each)."""
    return SLOT_BYTES + -(-12 * n // 16) * 16 + 20 * k


def cluster_smem(points: int) -> int:
    """Dynamic shared memory of a block of the cluster variant, as the
    kernel counts it: its slice of the cloud, 12 bytes a point."""
    return CLUSTER_THREADS * points * 12


def valid(plan: FpsPlan, n: int) -> bool:
    """Whether the kernel takes `plan` for a cloud of n points."""
    if plan.cluster:
        return (not plan.shared and plan.threads == CLUSTER_THREADS
                and ((plan.cluster in CLUSTER_SIZES
                      and plan.points in CLUSTER_POINTS)
                     or (plan.stream and plan.cluster == STREAM_CLUSTER))
                and plan.capacity >= n)
    allowed = (SHARED_POINTS,) if plan.shared else REG_POINTS
    return (1 <= plan.warps <= MAX_WARPS and plan.points in allowed
            and plan.threads <= max_threads(plan.points, plan.shared)
            and plan.capacity >= n)


def candidates(n: int) -> list[FpsPlan]:
    """Every plan the kernel takes for a cloud of n points, the register
    variants first, narrow blocks first."""
    out = []
    warps = 1
    while warps <= MAX_WARPS:
        out += [p for p in (FpsPlan(warps, r, False) for r in REG_POINTS)
                if valid(p, n)]
        warps *= 2
    shared = FpsPlan(MAX_WARPS, SHARED_POINTS, True)
    return out + ([shared] if valid(shared, n) else [])


def default_active(c: int, r: int, sms: int) -> int:
    """Clouds the card runs at once with the cluster build (c, r), where
    no card was asked: one 1024-thread block an SM, a cloud taking c
    SMs."""
    return sms // c


def plan_fps(b: int, n: int, k: int, *, sms: int, smem_limit: int,
             active=None) -> FpsPlan:
    """The plan for B clouds of n points and k picks on a card of `sms`
    SMs whose blocks may hold `smem_limit` bytes of shared memory;
    `active(c, r)` the clouds the card runs at once with a cluster build
    (`default_active` where None)."""
    if min(b, n, k, sms) < 1:
        raise ValueError(f"plan_fps needs positive sizes, got b={b}, n={n}, "
                         f"k={k}, sms={sms}")
    if max(n, k, b * STREAM_CLUSTER) > MAX_POINTS:
        raise ValueError(f"B={b}, N={n}, k={k} exceed int32 indexing")
    if fps_smem(n, k) <= smem_limit:
        floor = 1          # no wider than the cloud: a warp of 32 points
        while (floor < PLAN_WARPS and b * floor < sms * WARPS_PER_SM
               and 32 * floor < n):
            floor *= 2
        for plan in candidates(n):
            if plan.warps >= floor:
                return plan
    return plan_cluster(b, n, sms=sms, smem_limit=smem_limit, active=active)


def cluster_candidates(n: int, *, smem_limit: int) -> list[FpsPlan]:
    """Each C's plan that holds a cloud of n points in its slices (the
    fewest points a thread), smallest C first."""
    out = []
    for c in CLUSTER_SIZES:
        for r in CLUSTER_POINTS:
            plan = FpsPlan(CLUSTER_THREADS // 32, r, False, c)
            if valid(plan, n) and cluster_smem(r) <= smem_limit:
                out.append(plan)
                break
    return out


def plan_cluster(b: int, n: int, *, sms: int, smem_limit: int,
                 active=None) -> FpsPlan:
    """The cluster variant's plan for B clouds of n points: of the C that
    hold the cloud in their slices, the one whose launch runs in the
    fewest waves of the clouds the card runs at once (`active(c, r)`), the
    smallest on a tie; else streamed."""
    active = active or (lambda c, r: default_active(c, r, sms))
    best = None
    for plan in cluster_candidates(n, smem_limit=smem_limit):
        at_once = active(plan.cluster, plan.points)
        if at_once < 1:
            continue
        waves = -(-b // at_once)
        if best is None or waves < best[0]:
            best = (waves, plan)
    if best is not None:
        return best[1]
    return FpsPlan(CLUSTER_THREADS // 32, 0, False, STREAM_CLUSTER)
