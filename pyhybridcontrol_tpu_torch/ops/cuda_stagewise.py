"""The stagewise frame's kernels (CUDA C++, ``csrc/stagewise.cu`` and
``csrc/stagewise_any.cu``): K4, the block-tridiagonal sweep K⁻¹r; K5, the
fused stagewise ADMM loop; K6, the sweep at any block size, sequential or
over windows; their plans and their wrappers.

No TPU kernel stands behind them. The reference runs the sweep as two
``lax.scan`` loops (``pyhybridcontrol_tpu/ops/stagewise.py::_solve_K``),
or with ``parallel_sweeps=True`` as log-depth prefixes
(``_solve_K_assoc``), and the ADMM iterations as one
``jax.lax.fori_loop`` (``stagewise_admm_solve``, ``:1011``) that XLA
compiles into one device loop. K4's plain version is
``ops/stagewise.py::_solve_K``, a Python loop over the stages; K5's is
``ops/stagewise.py::_admm_iterations``, torch ops around the plain sweeps;
K6's are ``_solve_K`` and ``_solve_K_windowed``.

``ops/stagewise.stagewise_admm_solve`` dispatches on the tensor's device
and the shapes (``_admm_route``): a CPU tensor runs the plain loop; a CUDA
tensor launches K5 once (``sw_admm_cuda``) wherever K5 has an
instantiation (``k5_plan``), and elsewhere (b above 128, a tree past K5's
clusters, a group mean over ranks) runs the torch loop on the card around
K4's standalone sweep (``sw_solve_k_cuda``, sequential, where ``k4_plan``
takes the shape) or K6's (``sw_solve_k_any_cuda``: any b, any N; over
``any_windows(N)`` windows with ``parallel_sweeps``). Both take r (…, N,
b) fp32 and the factors (L, U⁻¹, C) (N, b, b) fp32 on the same device,
shared by every problem of the batch. Each launch counts once in
``cuda_admm.LAUNCHES["stagewise_k4"]``, ``["stagewise_k6"]`` or, K5,
under its variant's name (``ADMM_LAUNCH``; its problem count P in
``LAUNCH_BATCHES``).

``plan_sweep_any`` picks K6's launch from the shapes alone, C = 1 or
``any_windows(N)`` windows (⌈√(2N)⌉, at most 16 and N): "narrow"
(k6_narrow) where b is up to 32 and the horizon's factors (and maps),
packed column-major (``pack_wide``), fit one CTA; else k6_wide, a
stage's rows over a cluster of up to 16 CTAs, its factors and maps read
as row slices (``pack_slices``, built once per packed tensor) through a
ring of bulk copies ("ring") or from device memory where two slices do
not fit ("l2"). It raises only where one problem's three vectors do not
fit a CTA (b above 19,364). The factors are packed once per factor
tuple, the maps cached on the prep (``any_maps``); a windowed k6_wide
sweep keeps its ends, carries and counters in a workspace per (device,
stream, shape).

``plan_sweep`` picks K4's instantiation from the shapes alone: the compiled
bound on the block size (8, 16, 32, 64 or 128, the smallest at or above b),
whether a block stages the three factor arrays in shared memory beside its
warps' r/y buffers, and the warps (problems) a block: 4, 2 or 1, the most
that fit. b above 128, or a horizon whose r/y buffer does not fit one
block, has no instantiation and raises ``NoInstantiation`` (``k4_plan``
reads it as None, and the route takes K6 there).

Above bmax 16 (the wide sweep) both kernels read the factors packed
(``pack_wide``: each stage block column-major, padded to a multiple of 4
words), which the wrappers build once per prep (K5, ``admm_constants``) or
per factor tuple (K4, ``_WIDE_PACKED``). Unstaged there, the sweep warp
reads them through a ring of D blocks in shared memory that bulk copies
keep filled (``RING_DEPTHS``: the deepest that fits); K4 then runs one
problem a block, so that each ring has its SM's copy engine and L2
bandwidth to itself. A shape whose ring does not fit raises.

``plan_admm`` picks K5's from the shapes alone: the bound on b (8, 16, 32,
64 or 128, K4's ladder), the lanes a stage (the most, a power of 2 up to
32, that the CTA's 512 threads, 256 from bmax 16, give every stage at
once) and the warps a CTA, staged factors where they fit its shared
memory, the path of the extra rows, and one of four variants. "shared"
(the first design): one CTA a problem (a scenario), a group of S ≤ 8
scenarios with a group mean (a tree node) one portable cluster, the
scenario's z, y, l, u and buffers in shared memory.
Where that does not fit, the FLEX variants of the same kernel, a group
of S scenarios one portable cluster of ⌈S/spc⌉ CTAs, spc = ⌈S/8⌉
scenarios a CTA, each on its own share of the CTA's warps (so that a B&B
wave's clusters fit the card at once; ⌈S/16⌉, a cluster of up to 16, where
a slot would be under a warp or no place fits), the group mean over the members of
a scenario's node alone (``group_members``, built once per prep): by
where the state lies, "grouped", in shared memory; "global", z, y, l and
u in device memory (a scratch the wrapper allocates); "global_all", also
t, its M part, x, the consensus buffers and the horizon-sized constants.
Each counts its launches under its own name (``ADMM_LAUNCH``). Up to 4
extra rows at bmax 8 and 16 the register path runs (library
"stagewise"); more extra rows, or b above 16, run the runtime-r path
("stagewise_extra" at bmax 8 and 16, "stagewise_wide" at 32 to 128, the
wide row work there), whose Woodbury arrays (Aext and KiU,
Cw), whose J and Mc above bmax 16, and whose r-word vectors the plan
moves to device memory in turn, the largest first, until the CTA fits
(``AdmmPlan.ext``; ``EXT_*``). b above 128, or a shape that fits no
variant's shared memory (forced staged factors past it, a group whose
CTAs would give a scenario less than a warp) have no instantiation and
raise (``NoInstantiation`` where no argument was forced: ``k5_plan``
reads it as None, and the route runs the torch loop with K4 or K6).

Where the plan picks "global" for one scenario with no extra rows at bmax
8 or 16, it takes the "horizon" variant instead (library
"stagewise_horizon", ``horizon_plan``): one problem a cluster of C CTAs
(``HORIZON_CLUSTERS``), CTA c the window of stages ``horizon_windows(N,
C)[c:c+2]``, its factors (staged where they fit), state and buffers in its
shared memory; the most CTAs a problem whose P clusters the card holds
at once (``horizon_capacity``, cudaOccupancyMaxActiveClusters; planned
without a card, ``HORIZON_WAVE`` CTAs), else the fewest whose window fits,
which then runs in more than one wave (the wrapper warns). It runs the
sequential sweep over the windows, or with ``parallel`` (the reference's
``parallel_sweeps=True``) every window's sweep at once, joined by carries
through the window maps (``ops/stagewise.window_maps``); the parallel
sweep takes it at every such shape a window fits, whatever variant the
ladder picks (faster there than the windows inside one CTA). ``tps`` forces
the lanes a stage of any variant (the sequential horizon sweep is the
global variant's bit for bit at the same lanes).

At every other shape ``parallel`` runs the same algorithm inside the
variant the ladder picks (``AdmmPlan.windows`` = C, ``par_windows``): the
slot's warps sweep the C windows of its problem from a zero carry, one
warp composes the carries through the window maps (``par_maps``: one pair
a prep, read through L2), every thread corrects its stages, and the
Woodbury step, the rows and the group mean read the corrected x. Those
instantiations are the "_par" libraries (``stagewise_par``,
``stagewise_wide_par``, ``stagewise_extra_par``: parts 0 to 2 built with
PHC_SW_PAR), so that the sequential ones keep their machine code; their
launches count under the variant's name with PAR_SUFFIX.
"""

from __future__ import annotations

import ctypes
import dataclasses
import functools
import warnings
from typing import Optional

import numpy as np
import torch

from pyhybridcontrol_tpu_torch.ops.cuda_admm import (
    SMEM_MAX,
    _count_launch,
    _ptr,
    _raise_on,
)

SWEEP_WARPS = (4, 2, 1)          # problems (warps) a block, most first
SWEEP_BMAX = (8, 16, 32, 64, 128)   # compiled bounds on the block size
ADMM_BMAX = (8, 16, 32, 64, 128)   # K5's compiled bounds on the block size
# the most threads a K5 CTA has (from bmax 16 the kernel's launch bound)
ADMM_THREADS = {8: 512, 16: 256, 32: 256, 64: 256, 128: 256}
# the most CTAs a portable cluster: the shared variant's most scenarios a
# group, and a FLEX group's cluster where its slots hold a warp each
ADMM_CLUSTER = 8
ADMM_CLUSTER_MAX = 16            # the most CTAs a FLEX cluster (non-portable)
ADMM_RMAX = 4                    # extra rows the register path takes
# depths of the wide sweep's factor ring (blocks in flight), deepest first
RING_DEPTHS = (8, 4, 2)
# the runtime-r path (csrc/stagewise.cu kExt…): its bit, and the arrays it
# reads from device memory: Aext and KiU, Cw, the r-word vectors (z_e, y_e,
# the Woodbury sums and coefficient, ρₑ; in a per-problem scratch), and
# above bmax 16 J and Mc
EXT_RT, EXT_AK, EXT_CW, EXT_VEC, EXT_JM = 1, 2, 4, 8, 16
# K5's variants: the shared one, then the FLEX ones by the place of their
# arrays (0: shared memory, 1: z/y/l/u in device memory, 2: also t, mb, x,
# the consensus buffers and the horizon-sized constants), in the order the
# plan tries them; and the name each launch counts under
ADMM_PLACES = {"grouped": 0, "global": 1, "global_all": 2}
ADMM_LAUNCH = {"shared": "stagewise_k5", "grouped": "stagewise_k5_grouped",
               "global": "stagewise_k5_global",
               "global_all": "stagewise_k5_global_all",
               "horizon": "stagewise_k5_horizon"}
# the parallel sweep inside the shared and FLEX variants counts under the
# variant's name with this suffix (the horizon variant's under its own)
PAR_SUFFIX = "_par"
# the parallel sweep's windows a problem: the slot's warps, at least 2
# (where N ≥ 2) and at most PAR_WINDOWS (the kernel's kMaxWindows)
PAR_WINDOWS = 8
# the horizon variant: CTAs a cluster (one window each; portable sizes),
# most first, and the CTAs one wave of its clusters is reckoned to hold
# where the plan is made without a card (one CTA an SM: 16 clusters of 8,
# 32 of 4, 64 of 2 of the H100's 132 SMs); on the card the plan reads
# cudaOccupancyMaxActiveClusters (``horizon_capacity``)
HORIZON_CLUSTERS = (8, 4, 2)
HORIZON_WAVE = 128
_HORIZON_CAPACITY: dict = {}     # (plan, N, b, m, device) -> clusters


class NoInstantiation(ValueError):
    """A shape no instantiation of a kernel takes (as opposed to a forced
    argument that does not fit): ``plan_sweep`` and ``plan_admm`` raise it,
    ``k4_plan`` and ``k5_plan`` read it as None."""


@dataclasses.dataclass(frozen=True)
class SweepPlan:
    """Instantiation of K4 for one call: the compiled bound on b, staged
    factors, warps a block, dynamic shared memory (bytes) and the depth of
    a warp's factor ring (above bmax 16 unstaged; else 0)."""

    bmax: int
    staged: bool
    warps: int
    smem: int
    ring: int = 0


def _pad4(n: int) -> int:
    return (n + 3) // 4 * 4


def wide_block_words(b: int) -> int:
    """Words of one packed stage block of the wide sweep (``wide_block``):
    b² padded to a multiple of 4."""
    return _pad4(b * b)


def factor_words(N: int, b: int, bmax: int) -> int:
    """Words of one factor array as the kernels read it (``factor_words``):
    N·b² padded to a multiple of 4 up to bmax 16, N packed blocks above."""
    return _pad4(N * b * b) if bmax <= 16 else N * wide_block_words(b)


def ring_words(depth: int, b: int) -> int:
    """Words of a factor ring of ``depth`` packed blocks behind its
    mbarriers (two words each; ``ring_words``), none at depth 0."""
    return (_pad4(2 * depth) + depth * wide_block_words(b)) if depth else 0


def _ring_depths(bmax: int, staged: bool):
    """The ring depths a plan tries: RING_DEPTHS above bmax 16 unstaged,
    else none (0)."""
    return RING_DEPTHS if bmax > 16 and not staged else (0,)


def sweep_smem_bytes(N: int, b: int, warps: int, staged: bool,
                     bmax: int = 8, ring: int = 0) -> int:
    """Shared memory of one K4 block (``phc_sw_smem_bytes`` gives the
    same): N·b words of r/y a warp and its factor ring, plus the three
    factor arrays if staged, each array padded to a multiple of 4 words."""
    return 4 * ((3 * factor_words(N, b, bmax) if staged else 0)
                + warps * (_pad4(N * b) + ring_words(ring, b)))


def plan_sweep(P: int, N: int, b: int,
               staged: Optional[bool] = None) -> SweepPlan:
    """The instantiation K4 runs P problems of horizon N and block b with:
    staged factors where they fit a block beside at least one warp's y
    buffer (with the most warps that fit), else factors read through L2;
    above bmax 16 unstaged, one warp a block with the deepest factor ring
    of RING_DEPTHS that fits. ``staged`` asks for one variant. Raises
    ValueError where nothing fits: there is no other path."""
    what = "K4 (stagewise sweep)"
    if P < 1 or N < 1 or b < 1:
        raise ValueError(f"{what}: empty shape P={P}, N={N}, b={b}")
    bmax = next((m for m in SWEEP_BMAX if b <= m), None)
    if bmax is None:
        raise NoInstantiation(f"{what}: block size b={b} above the "
                              f"{SWEEP_BMAX[-1]} the kernel is built for")
    for st in ((True, False) if staged is None else (bool(staged),)):
        ring = _ring_depths(bmax, st)
        for w in (1,) if ring[0] else SWEEP_WARPS:
            for d in ring:
                smem = sweep_smem_bytes(N, b, w, st, bmax, d)
                if smem <= SMEM_MAX:
                    return SweepPlan(bmax=bmax, staged=st, warps=w,
                                     smem=smem, ring=d)
    least = _ring_depths(bmax, False)[-1]
    raise NoInstantiation(
        f"{what}: N={N}, b={b} needs "
        f"{sweep_smem_bytes(N, b, 1, False, bmax, least)} bytes of shared "
        f"memory for one warp's r/y buffer"
        + (" and its factor ring" if least else "")
        + (" and the staged factors" if staged else "")
        + f", above the {SMEM_MAX} an sm_90 block has")


def _check(name, t, shape, device):
    if t.device != device:
        raise ValueError(f"{name}: expected a tensor on {device}, got "
                         f"{t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def pack_wide(factors) -> torch.Tensor:
    """The factors (L, U⁻¹, C), each (N, b, b), as the wide sweep and K6
    read them (and K6's window maps (Π, Ψ) the same way): (n, N,
    ``wide_block_words(b)``) fp32 for n arrays, each stage block
    column-major (element (i, j) at word j·b + i, so that a warp's lanes
    read a column as consecutive words) and zero-padded to a multiple of 4
    words (every block 16-byte aligned, as a bulk copy needs)."""
    F = torch.stack([f.to(torch.float32) for f in factors])
    n, N, b, _ = F.shape
    out = torch.zeros((n, N, wide_block_words(b)), dtype=torch.float32,
                      device=F.device)
    out[:, :, :b * b] = F.transpose(-1, -2).reshape(n, N, b * b)
    return out


# K4's packed factors of the last few factor tuples it ran at bmax 32 to
# 128: (the tuple, its tensors' versions, the packed tensor). The entries
# hold the tensors, so that an id in the key is never another tensor's.
_WIDE_PACKED: list = []
_WIDE_PACKED_KEEP = 4


def _packed_for_k4(factors) -> torch.Tensor:
    """``pack_wide(factors)``, built once per factor tuple (while none of
    its tensors changes in place); K4 above bmax 16 and K6 read it."""
    vers = tuple(f._version for f in factors)
    for i, (fs, v, packed) in enumerate(_WIDE_PACKED):
        if len(fs) == len(factors) and all(
                a is b for a, b in zip(fs, factors)) and v == vers:
            _WIDE_PACKED.insert(0, _WIDE_PACKED.pop(i))
            return packed
    packed = pack_wide(factors)
    _WIDE_PACKED.insert(0, (tuple(factors), vers, packed))
    del _WIDE_PACKED[_WIDE_PACKED_KEEP:]
    return packed


def sw_solve_k_cuda(r, factors, staged: Optional[bool] = None):
    """K4 on the card: x = K⁻¹ r for r (…, N, b) from the factors
    (L, U⁻¹, C), each (N, b, b); above bmax 16 read packed
    (``pack_wide``, built once per factor tuple). ``staged`` asks for one
    variant instead of the plan's. Checks, allocates x and launches
    once."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    if r.device.type != "cuda":
        raise ValueError(f"K4: expected a CUDA tensor, got {r.device}")
    if r.ndim < 2:
        raise ValueError(f"K4: r must be (..., N, b), got {tuple(r.shape)}")
    N, b = r.shape[-2:]
    rr = r.reshape(-1, N, b)
    _check("r", rr, rr.shape, r.device)
    for name, f in zip(("L", "Uinv", "C"), factors):
        _check(name, f, (N, b, b), r.device)
    P = rr.shape[0]
    pl = plan_sweep(P, N, b, staged)
    if pl.bmax > 16:
        factors = tuple(_packed_for_k4(factors).unbind(0))
    x = torch.empty_like(rr)
    lib = load_library("stagewise")
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        rc = lib.phc_sw_solve_k(*map(_ptr, (rr, *factors, x)), P, N, b,
                                pl.warps, int(pl.staged), pl.bmax, pl.ring,
                                ctypes.c_void_p(stream))
    _raise_on(lib, rc, "K4 (stagewise sweep)")
    _count_launch("stagewise_k4", P)
    return x.reshape(r.shape)


# ---- K6: the sweep at any b, sequential or over windows -------------------

ANY_THREADS = 256    # the most threads a K6 CTA (csrc/stagewise_any.cu)
ANY_WINDOWS = 16     # the most windows plan_sweep_any gives a problem
ANY_CLUSTER = 16     # the largest cluster of k6_wide (16: non-portable)
ANY_GROUP = 8        # the problems a k6_wide cluster takes at least
ANY_WAVE = 112       # the CTAs of clusters the plan counts on the card
                     # holding at once (7 clusters of 16, 14 of 8, …)
ANY_RING = 48        # the deepest ring (slices) of k6_wide
ANY_ROWS = 16        # the rows a k6_wide CTA takes where a cluster allows
# the variants, by their number in phc_sw_solve_k_any
ANY_VARIANTS = ("narrow", "ring", "l2")


@dataclasses.dataclass(frozen=True)
class AnyPlan:
    """K6's launch for one call (csrc/stagewise_any.cu): the variant
    ("narrow": k6_narrow, b up to 32 with the horizon staged in one CTA;
    "ring" or "l2": k6_wide, a stage's rows over a cluster, the row slices
    through a ring of bulk copies or from device memory), windows a
    problem (1: the sequential sweep), CTAs a cluster (narrow: 1), rows a
    CTA (narrow: b), problems a cluster (narrow: a CTA), lanes a slot
    (narrow; else 0), the ring's depth in slices (0 but "ring"), threads
    and dynamic shared memory a CTA (bytes), and the clusters (narrow:
    CTAs) of the sweep."""

    variant: str
    windows: int
    cluster: int
    rows: int
    problems: int
    lanes: int
    ring: int
    threads: int
    smem: int
    clusters: int


def any_windows(N: int) -> int:
    """The windowed sweep's C for a horizon of N stages: ⌈√(2N)⌉, at least 2
    and at most ANY_WINDOWS and N (1 for N = 1). A window's chain is
    2·⌈N/C⌉ stages and the carries' 2·(C−1) steps, so the sum is least near
    √(2N). b does not enter: every term scales alike in b."""
    c = 2
    while c * c < 2 * N:
        c += 1
    return min(c, ANY_WINDOWS, N)


def _odd_quads(n: int) -> int:
    """n rounded up to a multiple of 4 words whose quarter is odd
    (``odd_quads``: eight such rows' 16-byte reads cover the 32 banks)."""
    w = _pad4(n)
    return w if (w // 4) % 2 else w + 4


def any_rows(b: int) -> tuple:
    """k6_wide's cluster for block size b: the fewest CTAs, a power of 2 up
    to ANY_CLUSTER, that leave a CTA at most ANY_ROWS rows (ANY_CLUSTER
    above 256), and the rows a CTA, ⌈b/CTAs⌉. Every problem of a CTA
    reads the CTA's row slice from shared memory, so fewer rows a CTA is
    fewer bytes read a stage."""
    cl = 1
    while cl < ANY_CLUSTER and -(-b // cl) > ANY_ROWS:
        cl *= 2
    return cl, -(-b // cl)


def any_slices(N: int, C: int) -> int:
    """The most row slices a k6_wide CTA reads for a horizon of N over C
    windows (its ring needs no more): its window's L (but the first stage)
    and C (but the last), U⁻¹ (window 0 in its forward sweep, the others in
    their corrections), and over windows Π and Ψ of the corrections and of
    the carries (C − 2 maps each way: the first step multiplies zero)."""
    w = horizon_windows(N, C)
    most = 0
    for c in range(C):
        ne = w[c + 1] - w[c]
        n = 3 * ne - 2
        if C > 1:
            n += ((C - 2) * (c == 0) + ne * (c > 0) + (C - 2) * (c == C - 1)
                  + ne * (c < C - 1))
        most = max(most, n)
    return most


def any_smem_bytes(variant: str, N: int, b: int, C: int, lanes: int = 0,
                   rows: int = 0, G: int = 1, ring: int = 0) -> int:
    """Shared memory of one K6 CTA (``phc_k6_smem_bytes`` gives the same).
    "narrow": its mbarrier (4 words), the staged arrays (L, U⁻¹, C and over
    windows Π, Ψ: N packed blocks each), its problems' r and x (G·N·b words
    each, padded to 4) and four ``lanes``-word vectors a slot (a stride of
    4·lanes + 1 words; G·C slots);
    "ring" and "l2": D + 2 mbarriers (the ring's and the exchange's, 2
    words each, padded to 4) and D = ``ring`` row slices (``rows`` rows of
    ``_odd_quads(b)`` words), then three vector buffers (two for the
    exchange, one for a carry) of G problems' vectors (``_odd_quads(b)``
    words each)."""
    if variant == "narrow":
        return 4 * (4 + (5 if C > 1 else 3) * N * wide_block_words(b)
                    + 2 * _pad4(G * N * b) + G * C * (4 * lanes + 1))
    D = ring if variant == "ring" else 0
    return 4 * (_pad4(2 * (D + 2)) + D * rows * _odd_quads(b)
                + 3 * G * _odd_quads(b))


def _narrow_plan(P, N, b, C):
    """k6_narrow's launch, or None where b is above 32 or the staged
    horizon does not fit a CTA: a slot of L lanes (b rounded up to a power
    of 2) a problem and window, all windows of a problem in one CTA; as
    many problems as one warp holds where a problem's slots fit one warp,
    else one problem a CTA (C·L ≤ 512 threads)."""
    if b > 32:
        return None
    L = 1
    while L < b:
        L *= 2
    if C * L <= 32:
        G, threads = min(P, 32 // (C * L)), 32
    else:
        G, threads = 1, -(-C * L // 32) * 32
    smem = any_smem_bytes("narrow", N, b, C, lanes=L, G=G)
    if smem > SMEM_MAX:
        return None
    return AnyPlan("narrow", C, 1, b, G, L, 0, threads, smem, -(-P // G))


def _wide_plan(P, N, b, C, variant):
    """k6_wide's launch ("ring" where two row slices fit beside the
    vectors, else "l2"; ``variant`` forces one), or None where not even
    one problem's vectors fit a CTA. The problems a cluster: ANY_GROUP, or
    more where that leaves the sweep more clusters than one wave of the
    card holds (ANY_WAVE CTAs; over windows every cluster must be resident
    for the one-launch form), fewer where their vectors or the ring do not
    fit; a thread a row of a problem (several where the rows pass
    ANY_THREADS − 32), the ring as deep as fits, at most ANY_RING and the
    slices a CTA reads (then the whole sweep's slices are staged), and
    with a ring one warp more, whose lane 0 keeps it filled."""
    cl, R = any_rows(b)
    wave = max(1, ANY_WAVE // cl // C)          # groups in one wave
    base = min(P, ANY_GROUP)
    for G in sorted({max(base, -(-P // wave)), base}, reverse=True):
        while G > 1 and any_smem_bytes("l2", N, b, C, rows=R,
                                       G=G) > SMEM_MAX:
            G = max(1, G // 2)
        vec = any_smem_bytes("l2", N, b, C, rows=R, G=G)
        if vec > SMEM_MAX:
            return None
        rows = -(-G * R // 32) * 32   # threads with rows
        clusters = -(-P // G) * C
        if variant != "l2":
            D = max(2, min(any_slices(N, C), ANY_RING))
            while D >= 2 and any_smem_bytes("ring", N, b, C, rows=R, G=G,
                                            ring=D) > SMEM_MAX:
                D -= 1
            if D >= 2:
                return AnyPlan("ring", C, cl, R, G, 0, D,
                               min(ANY_THREADS - 32, rows) + 32,
                               any_smem_bytes("ring", N, b, C, rows=R, G=G,
                                              ring=D), clusters)
            if variant == "ring" and G == base:
                return None
            if G != base:
                continue          # the ring at the smaller group first
        return AnyPlan("l2", C, cl, R, G, 0, 0, min(ANY_THREADS, rows), vec,
                       clusters)
    return None


def plan_sweep_any(P: int, N: int, b: int, windows: int = 1,
                   variant: Optional[str] = None) -> AnyPlan:
    """K6's launch for P problems of horizon N and block b over C =
    ``windows`` windows (1: the sequential sweep; the parallel sweep takes
    ``any_windows(N)``), from the shapes alone: "narrow" where b is up to
    32 and the horizon's factors (and maps) fit one CTA, else "ring" where
    two row slices fit beside the vectors, else "l2".
    ``variant`` forces one. Whether a windowed k6_wide sweep is one launch
    or five is decided on the card (``phc_sw_solve_k_any``: every cluster
    resident at once). Raises ValueError, with the shape, where C is not 1
    to N, on an empty shape, and where nothing fits: a forced variant that
    does not, or b whose three vectors do not fit a CTA (above 19,364)."""
    what = f"K6 (stagewise sweep at any b) at P={P}, N={N}, b={b}"
    if P < 1 or N < 1 or b < 1:
        raise ValueError(f"{what}: empty shape")
    C = windows
    if not 1 <= C <= N:
        raise ValueError(f"{what}: {C} windows, not 1 to N")
    if variant not in (None,) + ANY_VARIANTS:
        raise ValueError(f"{what}: no variant {variant!r}")
    if variant in (None, "narrow"):
        pl = _narrow_plan(P, N, b, C)
        if pl is not None:
            return pl
        if variant == "narrow":
            raise ValueError(f"{what}, C={C}: the narrow variant takes b up "
                             f"to 32 whose staged horizon fits a CTA")
    pl = _wide_plan(P, N, b, C, variant)
    if pl is None:
        if variant == "ring":
            raise ValueError(f"{what}, C={C}: no ring of two steps fits a "
                             f"CTA's {SMEM_MAX} bytes of shared memory")
        need = any_smem_bytes("l2", N, b, C, rows=any_rows(b)[1])
        raise ValueError(f"{what}: a stage's vectors need {need} bytes of "
                         f"shared memory, above the {SMEM_MAX} a CTA has")
    return pl


def any_maps(sw, windows: int) -> torch.Tensor:
    """The window maps (Π, Ψ) of ``windows`` windows over the prep ``sw``
    (``ops/stagewise.window_maps`` of ``horizon_windows``) as K6 reads
    them: (2, N, ``wide_block_words(b)``), each block column-major
    (``pack_wide``; cached on the prep; k6_wide reads their row slices,
    ``pack_slices``, built once a tensor)."""
    from pyhybridcontrol_tpu_torch.ops.stagewise import window_maps

    key = ("k6_maps", windows)
    got = sw.cache.get(key)
    if got is None:
        got = pack_wide(window_maps(sw, horizon_windows(sw.N, windows)))
        sw.cache[key] = got
    return got


def pack_slices(packed: torch.Tensor, b: int, cluster: int) -> torch.Tensor:
    """k6_wide's row slices of packed blocks (``pack_wide``'s (n, N,
    ``wide_block_words(b)``)): (n, N, cluster, R, ``_odd_quads(b)``), R =
    ⌈b/cluster⌉, slice [a, k, q] the rows q·R … q·R + R − 1 of block (a, k)
    row-major (element (i, j) of the block at [a, k, i div R, i mod R, j]),
    zero past b in either direction: one bulk copy a slice, each 16-byte
    aligned."""
    n, N = packed.shape[:2]
    R = -(-b // cluster)
    out = torch.zeros((n, N, cluster * R, _odd_quads(b)), dtype=torch.float32,
                      device=packed.device)
    out[:, :, :b, :b] = packed[:, :, :b * b].reshape(n, N, b, b).transpose(
        -1, -2)
    return out.reshape(n, N, cluster, R, _odd_quads(b))


# k6_wide's row slices of the last few packed tensors it read (the packed
# factors of ``_packed_for_k4``, the maps of ``any_maps``): (the tensor, its
# version, the cluster, the slices). The entries hold the tensors, so that
# an id in the key is never another tensor's.
_K6_SLICES: list = []
_K6_SLICES_KEEP = 6


def _slices_of(packed: torch.Tensor, b: int, cluster: int) -> torch.Tensor:
    """``pack_slices(packed, b, cluster)``, built once per packed tensor
    (while it does not change in place)."""
    for i, (t, v, cl, got) in enumerate(_K6_SLICES):
        if t is packed and v == packed._version and cl == cluster:
            _K6_SLICES.insert(0, _K6_SLICES.pop(i))
            return got
    got = pack_slices(packed, b, cluster)
    _K6_SLICES.insert(0, (packed, packed._version, cluster, got))
    del _K6_SLICES[_K6_SLICES_KEEP:]
    return got


# the windowed k6_wide sweep's workspace a (device, stream, shape): [the
# (4, P, C, b) words of the windows' ends and carries followed by the
# (⌈P/G⌉, C, 4) counters, zeroed once; the epoch of the last call that ran
# as one launch]. Such a call leaves every counter it uses at
# epoch·cluster, so none is ever reset (the five-launch form uses none).
_K6_WORK: dict = {}
_K6_WORK_KEEP = 8


def _k6_work(dev, stream: int, P: int, b: int, pl: AnyPlan):
    key = (dev, stream, P, b, pl.windows, pl.cluster, pl.problems)
    got = _K6_WORK.pop(key, None)
    if got is None:
        words = 4 * P * pl.windows * b + -(-P // pl.problems) * pl.windows * 4
        got = [torch.zeros(words, dtype=torch.float32, device=dev), 0]
    _K6_WORK[key] = got
    while len(_K6_WORK) > _K6_WORK_KEEP:
        del _K6_WORK[next(iter(_K6_WORK))]
    return got


def _k6_launch(r, factors, windows=None, maps=None, variant=None,
               multi=False, stamps=None):
    """K6 on the card, as ``sw_solve_k_any_cuda``, with the variant forced
    (``variant``; ``multi``: a windowed k6_wide sweep in five launches even
    where one fits) and ``stamps`` (None, or five uint64 counters on the
    card, k6_wide's cycles by part). Returns x and the kernel launches the
    call made."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    what = "K6 (stagewise sweep at any b)"
    if windows not in (None, 1) and maps is None:
        raise ValueError(f"{what}: {windows} windows need the window maps "
                         f"(cuda_stagewise.any_maps of the prep)")
    if r.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {r.device}")
    if r.ndim < 2:
        raise ValueError(f"{what}: r must be (..., N, b), got "
                         f"{tuple(r.shape)}")
    N, b = r.shape[-2:]
    rr = r.reshape(-1, N, b)
    _check("r", rr, rr.shape, r.device)
    for name, f in zip(("L", "Uinv", "C"), factors):
        _check(name, f, (N, b, b), r.device)
    P = rr.shape[0]
    pl = plan_sweep_any(P, N, b, 1 if windows is None else windows, variant)
    F, M = _packed_for_k4(factors), None
    if pl.windows > 1:
        _check("maps", maps, (2, N, wide_block_words(b)), r.device)
        M = maps
    if pl.variant != "narrow":
        F = _slices_of(F, b, pl.cluster)
        M = None if M is None else _slices_of(M, b, pl.cluster)
    x = torch.empty_like(rr)
    lib = load_library("stagewise_any")
    launches = ctypes.c_int(0)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream(r.device).cuda_stream
        work = None
        if pl.variant != "narrow" and pl.windows > 1:
            work = _k6_work(r.device, stream, P, b, pl)
        rc = lib.phc_sw_solve_k_any(
            *map(_ptr, (rr, x, F, M, None if work is None else work[0],
                        stamps)), P, N, b, pl.windows,
            ANY_VARIANTS.index(pl.variant), pl.cluster, pl.rows, pl.problems,
            pl.lanes, pl.ring, pl.threads,
            0 if work is None else work[1] + 1, int(multi),
            ctypes.byref(launches), ctypes.c_void_p(stream))
    _raise_on(lib, rc, what)
    if work is not None and launches.value == 1:
        work[1] += 1
    _count_launch("stagewise_k6", P)
    return x.reshape(r.shape), launches.value


def sw_solve_k_any_cuda(r, factors, windows: Optional[int] = None,
                        maps: Optional[torch.Tensor] = None):
    """K6 on the card: x = K⁻¹ r for r (…, N, b) from the factors (L, U⁻¹,
    C), each (N, b, b), at any b; sequential, or over ``windows`` windows
    (the algorithm of ``ops/stagewise._solve_K_windowed``, its plain
    version; ``_solve_K`` is the sequential one's) with the window maps
    ``maps`` (``any_maps`` of the prep; required with more than one
    window). The factors are read packed (``pack_wide``, built once per
    factor tuple) or in row slices (``pack_slices``, built once per packed
    tensor), as ``plan_sweep_any`` picks. Checks, allocates x and launches
    once: one kernel, or five for a windowed k6_wide sweep whose clusters
    are not all resident at once."""
    return _k6_launch(r, factors, windows, maps)[0]



@dataclasses.dataclass(frozen=True)
class AdmmPlan:
    """Instantiation of K5 for one call: the compiled bound on b, staged
    factors, warps a CTA, lanes a stage (its rows dealt over them), CTAs a
    cluster, dynamic shared memory a CTA (bytes), scenarios a CTA, the
    variant (``ADMM_LAUNCH``'s keys), the extra rows' path (0: the
    register path; else EXT_RT and the bits of what lies in device
    memory), the depth of a slot's factor ring (above bmax 16
    unstaged; else 0), for the horizon variant (``cluster`` CTAs a
    problem, one window each) whether it runs the parallel sweep, and for
    a FLEX variant with a group mean the words of the member lists
    (``group_members``) its CTAs stage (0: read from device memory); for
    the parallel sweep inside the other variants (``parallel``), its
    windows a problem (0: the sequential sweep)."""

    bmax: int
    staged: bool
    warps: int
    tps: int
    cluster: int
    smem: int
    spc: int = 1
    variant: str = "shared"
    ext: int = 0
    ring: int = 0
    parallel: bool = False
    lists: int = 0
    windows: int = 0

    @property
    def library(self) -> str:
        """The kernel library holding this instantiation (the parallel
        sweep's in the "_par" twin of its part)."""
        if self.variant == "horizon":
            return "stagewise_horizon"
        if not self.ext:
            name = "stagewise"
        else:
            name = "stagewise_wide" if self.bmax > 16 else "stagewise_extra"
        return name + ("_par" if self.windows else "")

    @property
    def launch(self) -> str:
        """The name this plan's launches count under (``ADMM_LAUNCH``, with
        PAR_SUFFIX for the parallel sweep outside the horizon variant)."""
        return ADMM_LAUNCH[self.variant] + (PAR_SUFFIX if self.windows
                                            else "")


def _jm_words(m, b, bmax, ext):
    """Words of J and of Mc in shared memory (``jm_words``): rows of bmax
    words up to bmax 16, of b words above, none in device memory."""
    if bmax <= 16:
        return _pad4(m * bmax)
    return 0 if ext & EXT_JM else _pad4(m * b)


def _vec_words(n_ext, ext):
    """Words of a scenario's Woodbury coefficient and extra-row vectors in
    shared memory (``vec_words``): 4 on the register path, 4 arrays of
    n_ext words on the runtime-r path, none in device memory."""
    if not ext:
        return ADMM_RMAX
    return 0 if ext & EXT_VEC else 4 * _pad4(n_ext)


def _const_words(N, b, m, n_blk, n_ext, staged, bmax, ext, hz=True):
    """Words of the constants a CTA stages: the factors if staged (above
    bmax 16 the packed blocks of an even b, which fill N·b² words with no
    padding: an odd b there is never staged), J and Mc, the blocking rows'
    ties (``hz``) and columns, Aext and KiU (``hz``, unless in device
    memory), Cw and ρₑ (unless in device memory)."""
    f = _pad4(N * b * b) if staged else 0
    ak = 0 if (ext & EXT_AK or not hz) else _pad4(n_ext * N * b)
    return (3 * f + 2 * _jm_words(m, b, bmax, ext)
            + (_pad4(N * n_blk) if hz else 0) + _pad4(n_blk) + 2 * ak
            + (0 if ext & EXT_CW else _pad4(n_ext * n_ext))
            + (0 if ext & EXT_VEC else _pad4(n_ext)))


def admm_smem_bytes(N: int, b: int, m: int, S: int, n_blk: int, n_ext: int,
                    n_cons: int, mean: bool, warps: int, staged: bool,
                    bmax: int, ext: int = 0, ring: int = 0,
                    windows: int = 0) -> int:
    """Shared memory of one CTA of the shared variant
    (``phc_sw_admm_smem_bytes`` gives the same): the factors if staged, J
    and Mc (rows of bmax words to bmax 16, of b words above), the blocking
    rows' ties and columns, Aext, KiU, Cw and ρₑ (those ``ext`` does not
    put in device memory), the scenario's row of group-mean weights, its
    z, y, l and u (m·N words each; above bmax 16 also w), t, its M part and
    x (N·b words each), two consensus-row buffers with a group mean, and on
    the register path 4·(1 + warps) words of Woodbury coefficient and
    sums, on the runtime-r one its four r-word vectors, the parallel
    sweep's carries (b words each of its ``windows`` windows) and the sweep
    warp's factor ring of ``ring`` blocks; each array padded to a multiple
    of 4 words."""
    words = (_const_words(N, b, m, n_blk, n_ext, staged, bmax, ext)
             + (_pad4(S * N) if mean else 0)
             + (5 if bmax > 16 else 4) * _pad4(m * N)
             + 3 * _pad4(N * b) + (2 * _pad4(N * n_cons) if mean else 0)
             + _vec_words(n_ext, ext) + (0 if ext else ADMM_RMAX * warps)
             + _pad4(windows * b) + ring_words(ring, b))
    return 4 * words


def _flex_words(N, b, m, n_cons, mean, place, bmax=8):
    """(words of a scenario's arrays in its slot, words in device memory)
    of a FLEX variant, without the slot's Woodbury coefficient and sums:
    z, y, l, u (m·N words each; above bmax 16 also w) in the slot at place
    0, else in device memory; t, mb, x (N·b each) and the two consensus
    buffers in the slot below place 2."""
    zyl = (5 if bmax > 16 else 4) * _pad4(m * N)
    tmx = 3 * _pad4(N * b) + (2 * _pad4(N * n_cons) if mean else 0)
    slot = (zyl if place < 1 else 0) + (tmx if place < 2 else 0)
    return slot, (zyl if place >= 1 else 0) + (tmx if place >= 2 else 0)


def flex_smem_bytes(N: int, b: int, m: int, n_blk: int, n_ext: int,
                    n_cons: int, mean: bool, warps: int, staged: bool,
                    bmax: int, spc: int, place: int, ext: int = 0,
                    ring: int = 0, lists: int = 0, S: int = 1,
                    windows: int = 0) -> int:
    """Shared memory of one CTA of a FLEX variant
    (``phc_sw_admm_flex_smem_bytes`` gives the same): the constants as the
    shared variant's (the ties, Aext and KiU only below place 2; no
    group-mean weights), the ``lists`` words of the group mean's member
    lists it stages and, with a group mean, the address of each of the S
    scenarios' consensus buffers (two words each), then ``spc`` slots of a
    scenario's shared arrays (``_flex_words``), its Woodbury coefficient
    and sums or runtime-r vectors, its sweep warp's factor ring of
    ``ring`` blocks and the parallel sweep's carries (b words each of its
    ``windows`` windows); ``warps`` the CTA's."""
    const = (_const_words(N, b, m, n_blk, n_ext, staged, bmax, ext,
                          hz=place < 2) + _pad4(lists)
             + (_pad4(2 * S) if mean else 0))
    slot = (_flex_words(N, b, m, n_cons, mean, place, bmax)[0]
            + _vec_words(n_ext, ext)
            + (0 if ext else ADMM_RMAX * (warps // spc))
            + ring_words(ring, b) + _pad4(windows * b))
    return 4 * (const + spc * slot)


def flex_scratch_words(N: int, b: int, m: int, n_cons: int, mean: bool,
                       place: int, bmax: int = 8) -> int:
    """Words of device memory a problem's scratch takes in a FLEX variant
    (``phc_sw_admm_flex_scratch_words`` gives the same)."""
    return _flex_words(N, b, m, n_cons, mean, place, bmax)[1]


def ext_scratch_words(n_ext: int) -> int:
    """Words of device memory a problem's runtime-r vectors take where
    EXT_VEC puts them there (the kernel's ``4·pad4(r)``)."""
    return 4 * _pad4(n_ext)


def _ext_ladder(N: int, b: int, m: int, n_ext: int, bmax: int,
                runtime_r: bool):
    """The extra rows' paths the plan tries, in turn: the register path
    alone, or the runtime-r path with its arrays moved to device memory
    one kind at a time, the largest first of the Woodbury arrays (Aext
    with KiU, Cw), then J with Mc (above bmax 16; read N times an
    iteration), then the r-word vectors (read in every stage)."""
    if not runtime_r:
        return (0,)
    ext, out = EXT_RT, [EXT_RT]
    for _, bit in sorted(((2 * n_ext * N * b, EXT_AK),
                          (n_ext * n_ext, EXT_CW)), key=lambda t: -t[0]):
        ext |= bit
        out.append(ext)
    if bmax > 16:
        ext |= EXT_JM
        out.append(ext)
    out.append(ext | EXT_VEC)
    return tuple(out)


def _lanes(N: int, threads: int, tps: Optional[int] = None):
    """(lanes a stage, warps) of ``threads`` threads over N stages: the
    most lanes (a power of 2 up to 32) with every stage in one round, or
    ``tps`` where given, and no more warps than that takes."""
    if tps is None:
        tps = 32
        while tps > 1 and N * tps > threads:
            tps //= 2
    return tps, min(threads, -(-N * tps // 32) * 32) // 32


def horizon_windows(N: int, C: int) -> tuple:
    """The stage bounds of the horizon variant's C windows over N stages
    (``hz_lo``): window c is [w[c], w[c+1]), w[c] = c·N div C."""
    return tuple(c * N // C for c in range(C + 1))


def horizon_smem_bytes(N: int, b: int, m: int, staged: bool, bmax: int,
                       C: int) -> int:
    """Shared memory of one CTA of the horizon variant
    (``phc_sw_admm_horizon_smem_bytes`` gives the same), laid out for
    windows of nw = ⌈N/C⌉ stages: two mbarriers (4 words), the window's
    factors if staged, J and Mc in rows of bmax words, z, y, l and u (m·nw
    words each), t, mb and x (nw·b each), five b-word vectors (the halo,
    two carries in, the two published ones), the carries' 2·C window maps
    (b² words each) and the peers' vectors a carry reads (C·b words), each
    array padded to a multiple of 4 words."""
    nw = -(-N // C)
    f = _pad4(nw * b * b) if staged else 0
    return 4 * (4 + 3 * f + 2 * _pad4(m * bmax) + 4 * _pad4(m * nw)
                + 3 * _pad4(nw * b) + 5 * _pad4(b) + _pad4(2 * C * b * b)
                + _pad4(C * b))


def horizon_applies(b: int, S: int = 1, mean: bool = False,
                    n_ext: int = 0) -> bool:
    """Whether the horizon variant takes the shape: one scenario (no group
    mean), no extra rows, b up to 16."""
    return b <= 16 and S == 1 and not mean and n_ext == 0


def horizon_plan(P: int, N: int, b: int, m: int,
                 staged: Optional[bool] = None, parallel: bool = False,
                 tps: Optional[int] = None,
                 device: Optional[torch.device] = None) -> Optional[AdmmPlan]:
    """The horizon variant's instantiation for P problems (``horizon_applies``
    must hold), or None where no window fits a CTA: C of HORIZON_CLUSTERS
    (at most N; 1 for N = 1), the most whose P clusters the card holds at
    once (``horizon_capacity`` on a CUDA ``device``; else the reckoned
    HORIZON_WAVE CTAs), else the fewest whose window fits; in each staged
    factors before unstaged (``staged`` forces one); a window's stages over
    the most lanes that take them in one round (``tps`` forces them)."""
    bmax = next(v for v in ADMM_BMAX if b <= v)
    cands = [C for C in HORIZON_CLUSTERS if C <= N] or [1]
    sts = (True, False) if staged is None else (bool(staged),)

    def fit(C):
        lanes, warps = _lanes(-(-N // C), ADMM_THREADS[bmax], tps)
        for st in sts:
            smem = horizon_smem_bytes(N, b, m, st, bmax, C)
            if smem <= SMEM_MAX:
                return AdmmPlan(bmax=bmax, staged=st, warps=warps, tps=lanes,
                                cluster=C, smem=smem, variant="horizon",
                                parallel=parallel)
        return None

    def held(pl):
        if device is not None and torch.device(device).type == "cuda":
            return horizon_capacity(N, b, m, pl, device)
        return HORIZON_WAVE // pl.cluster

    fits = {C: fit(C) for C in cands}
    wave = [fits[C] for C in cands if fits[C] and P <= held(fits[C])]
    # most CTAs a problem in one wave, else the fewest whose window fits
    return wave[0] if wave else next(
        (fits[C] for C in reversed(cands) if fits[C]), None)


def par_windows(warps: int, N: int) -> int:
    """The parallel sweep's windows for a problem of horizon N on a slot
    of ``warps`` warps (one window a warp): at least 2 where N ≥ 2, at most
    N and PAR_WINDOWS."""
    return min(max(warps, 2), N, PAR_WINDOWS)


def plan_admm(P: int, N: int, b: int, m: int, S: int = 1, n_blk: int = 0,
              n_ext: int = 0, n_cons: int = 0, mean: bool = False,
              staged: Optional[bool] = None,
              variant: Optional[str] = None,
              runtime_r: Optional[bool] = None, parallel: bool = False,
              tps: Optional[int] = None,
              device: Optional[torch.device] = None,
              members: int = 0, spc: Optional[int] = None) -> AdmmPlan:
    """The instantiation K5 runs P problems with: horizon N, block b, m rows
    a stage, n_blk blocking rows and n_ext extra rows; with ``mean``, in
    groups of S scenarios (a group mean over the trailing n_cons rows), a
    cluster each. A stage's rows over ``tps`` lanes, the most (a power of
    2 up to 32) with every stage in one round of the CTA's (or its slot's)
    threads. The variants in turn, staged factors before unstaged in each,
    and in each the extra rows' placements of ``_ext_ladder`` (the register
    path up to ADMM_RMAX extra rows at bmax 8 and 16, else the runtime-r
    path, its arrays moved to device memory the largest first), and in
    each above bmax 16 unstaged the deepest factor ring of RING_DEPTHS
    that fits: the shared one (S ≤ 8); grouped, global, global_all
    (module doc). The FLEX variants deal a group over spc = ⌈S/8⌉
    scenarios a CTA, in a portable cluster of ⌈S/spc⌉ ≤ 8 CTAs (where
    that leaves a slot less than a warp, above S = 128 or 64 from bmax 16,
    or where no place fits its slots, as a slot's own factor ring above
    bmax 32 may not: ⌈S/16⌉, a non-portable cluster of up to 16), with the
    group mean's ``members`` words of member lists (``group_members``) staged
    where they fit beside a candidate, else read from device memory.
    Where that picks "global" and ``horizon_applies``, the
    horizon variant (``horizon_plan``; its cluster from the occupancy of
    a CUDA ``device``) where a window fits. ``parallel`` (the reference's
    ``parallel_sweeps=True``): the parallel sweep in the horizon variant
    wherever that takes the shape and a window fits, else inside the
    variant the ladder picks (``windows`` from the slot's warps,
    ``par_windows``; no factor ring, the carries beside the state; the
    "_par" libraries). ``staged``,
    ``variant``, ``runtime_r``, ``tps`` and ``spc`` force one: no path
    sets them, ``chip_smoke.py`` holds the unstaged, the global-state,
    the runtime-r instantiations and the grouped variant's earlier
    placement (spc = ⌈S/16⌉) with them at shapes the plan gives others.
    Raises ValueError, with the shape, where nothing fits: there is no
    other path."""
    shape = (f"P={P}, N={N}, b={b}, m={m}, S={S}, n_blk={n_blk}, "
             f"n_ext={n_ext}, n_cons={n_cons}")
    what = f"K5 (stagewise ADMM) at {shape}"
    if min(P, N, b, m, S) < 1 or n_ext < 0:
        raise ValueError(f"{what}: empty shape")
    bmax = next((v for v in ADMM_BMAX if b <= v), None)
    if bmax is None:
        raise NoInstantiation(f"{what}: block size b={b} above the "
                              f"{ADMM_BMAX[-1]} the kernel is built for")
    needs_rt = bmax > 16 or n_ext > ADMM_RMAX
    if runtime_r is None:
        runtime_r = needs_rt
    elif needs_rt and not runtime_r:
        raise ValueError(f"{what}: the register path takes at most "
                         f"{ADMM_RMAX} extra rows and b up to 16")
    if mean and not 1 <= n_cons <= m:
        raise ValueError(f"{what}: a group mean needs 1 to m consensus rows")
    if not mean and S != 1:
        raise ValueError(f"{what}: groups of scenarios come with a group "
                         f"mean")
    if P % S:
        raise ValueError(f"{what}: P is no multiple of the group of S")
    if variant is not None and variant not in ADMM_LAUNCH:
        raise ValueError(f"{what}: no variant {variant!r}")
    if tps is not None and (tps not in (1, 2, 4, 8, 16, 32)):
        raise ValueError(f"{what}: {tps} lanes a stage is no power of 2 up "
                         f"to 32")
    hz = horizon_applies(b, S, mean, n_ext) and not runtime_r
    if variant == "horizon":
        if not hz:
            raise ValueError(f"{what}: the horizon variant takes one "
                             f"scenario, no extra rows and b up to 16")
        pl = horizon_plan(P, N, b, m, staged, parallel, tps, device)
        if pl is None:
            raise ValueError(f"{what}: no window of the horizon variant fits "
                             f"a CTA's {SMEM_MAX} bytes of shared memory")
        return pl
    if parallel and variant is None and hz:
        # the parallel sweep in the horizon variant's cluster wherever that
        # takes the shape and a window fits (the sequential ladder's plan
        # where it picks "global"; at the short single scenarios timed,
        # faster than the windows inside the shared variant's one CTA)
        pl = horizon_plan(P, N, b, m, staged, parallel, tps, device)
        if pl is not None:
            return pl
    most = ADMM_THREADS[bmax]

    # the parallel sweep reads the factors where they lie (no ring) and
    # keeps its windows' carries beside the state: C windows for a slot of
    # w warps (``par_windows``)
    def rings(st):
        return (0,) if parallel else _ring_depths(bmax, st)

    def wins(w):
        return par_windows(w, N) if parallel else 0

    # above bmax 16 an odd b's packed blocks are padded apart, which the
    # staged layout does not hold: such a shape streams them (the ring)
    odd_wide = bmax > 16 and b % 2 == 1
    if staged and odd_wide:
        raise ValueError(f"{what}: an odd b above 16 is not staged")
    sts = ((False,) if odd_wide else (True, False)) if staged is None \
        else (bool(staged),)
    exts = _ext_ladder(N, b, m, n_ext, bmax, runtime_r)
    smem = None
    if variant in (None, "shared") and S <= ADMM_CLUSTER:
        lanes, warps = _lanes(N, most, tps)
        for st in sts:
            for ext in exts:
                for d in rings(st):
                    smem = admm_smem_bytes(N, b, m, S, n_blk, n_ext, n_cons,
                                           mean, warps, st, bmax, ext, d,
                                           wins(warps))
                    if smem <= SMEM_MAX:
                        return AdmmPlan(bmax=bmax, staged=st, warps=warps,
                                        tps=lanes, cluster=S, smem=smem,
                                        ext=ext, ring=d, parallel=parallel,
                                        windows=wins(warps))
    if variant == "shared":
        raise ValueError(
            f"{what}: the shared variant " + (
                f"needs {smem} bytes of shared memory a CTA, above the "
                f"{SMEM_MAX} an sm_90 CTA has" if smem else
                f"takes groups of at most {ADMM_CLUSTER} scenarios"))
    if spc is not None:
        if not 1 <= spc <= S or -(-S // spc) > ADMM_CLUSTER_MAX:
            raise ValueError(f"{what}: {spc} scenarios a CTA give no "
                             f"cluster of at most {ADMM_CLUSTER_MAX} CTAs")
        spcs = (spc,)
    else:
        # portable clusters where their slots hold a warp each and some
        # place fits, else clusters of up to 16
        spcs = tuple(dict.fromkeys((-(-S // ADMM_CLUSTER),
                                    -(-S // ADMM_CLUSTER_MAX))))
    lists = members if mean else 0
    names = ADMM_PLACES if variant is None else (variant,)
    for spc in spcs:
        sub = most // spc // 32 * 32        # threads a scenario's slot
        if sub < 32:
            if spc == spcs[-1]:
                raise NoInstantiation(f"{what}: {spc} scenarios a CTA "
                                      f"leave less than a warp each")
            continue
        lanes, w = _lanes(N, sub, tps)
        for name in names:
            for st in sts:
                for ext in exts:
                    for d in rings(st):
                        # the member lists staged where they fit, else
                        # read from device memory
                        for ls in dict.fromkeys((lists, 0)):
                            smem = flex_smem_bytes(
                                N, b, m, n_blk, n_ext, n_cons, mean,
                                w * spc, st, bmax, spc, ADMM_PLACES[name],
                                ext, d, ls, S, wins(w))
                            if smem <= SMEM_MAX:
                                break
                        if smem > SMEM_MAX:
                            continue
                        if name == "global" and variant is None and hz \
                                and not ext:
                            got = horizon_plan(P, N, b, m, staged, parallel,
                                               tps, device)
                            if got is not None:
                                return got
                        return AdmmPlan(bmax=bmax, staged=st, warps=w * spc,
                                        tps=lanes, cluster=-(-S // spc),
                                        smem=smem, spc=spc, variant=name,
                                        ext=ext, ring=d, lists=ls,
                                        parallel=parallel, windows=wins(w))
    raise NoInstantiation(f"{what}: needs {smem} bytes of shared memory a "
                          f"CTA, above the {SMEM_MAX} an sm_90 CTA has")


@functools.lru_cache(maxsize=256)
def k5_plan(N: int, b: int, m: int, S: int = 1, n_blk: int = 0,
            n_ext: int = 0, n_cons: int = 0, mean: bool = False,
            parallel: bool = False) -> Optional[AdmmPlan]:
    """K5's plan for one group of the shape (``plan_admm`` at P = S, the
    plan's own choices, no card read), or None where K5 has no
    instantiation for it (b above 128, a group that leaves a scenario
    under a warp, no variant's shared memory fits): the shapes the torch
    loop takes on the card (``ops/stagewise._admm_route``). Whether a plan
    exists does not depend on P, only which horizon cluster it takes. A
    pure function of its arguments, memoized: the route asks it on every
    solve."""
    try:
        return plan_admm(S, N, b, m, S, n_blk, n_ext, n_cons, mean,
                         parallel=parallel)
    except NoInstantiation:
        return None


@functools.lru_cache(maxsize=256)
def k4_plan(N: int, b: int) -> Optional[SweepPlan]:
    """K4's plan for the shape (``plan_sweep``, which does not depend on
    P), or None where K4 has no instantiation (b above 128, one problem's
    r/y buffer past a block); memoized, as ``k5_plan``."""
    try:
        return plan_sweep(1, N, b)
    except NoInstantiation:
        return None


def group_members(M: torch.Tensor) -> torch.Tensor:
    """The group mean of ``M`` (S, S, N; z_s,k = Σ_t M[s, t, k]·v_t,k) as
    K5's FLEX variants read it: int32 words, exact for any M. The stages
    fall into runs over which M[:, :, k] is bitwise equal; in a run, the
    scenarios whose rows are bitwise equal (a tree's node) share one list
    of their row's nonzero (t, weight) pairs in ascending t, the weight's
    fp32 bits as they are in M. Words [0, N): for stage k, the offset o_k
    of its run's block; block words o_k + 2s, o_k + 2s + 1: the words
    [begin, end) of scenario s's list; the lists, two words a pair (t,
    then the weight), every pair at an even word. Summing w·v over
    a list in its order is the mean over all S scenarios in scenario order
    with the zero weights left out."""
    Mn = M.detach().to("cpu", torch.float32).contiguous().numpy()
    S, _, N = Mn.shape
    bits = Mn.view(np.uint32)
    new = np.ones(N, bool)
    new[1:] = (bits[:, :, 1:] != bits[:, :, :-1]).any(axis=(0, 1))
    starts = np.flatnonzero(new)
    head = _pad4(N)
    pos = head + 2 * S * len(starts)
    ranges = np.zeros((len(starts), S, 2), np.uint32)
    pairs = []
    for r, k in enumerate(starts):
        seen = {}
        for s in range(S):
            key = bits[s, :, k].tobytes()
            if key not in seen:
                t = np.flatnonzero(Mn[s, :, k] != 0).astype(np.uint32)
                pairs.append(np.stack([t, bits[s, t, k]], 1).ravel())
                seen[key] = (pos, pos + pairs[-1].size)
                pos += pairs[-1].size
            ranges[r, s] = seen[key]
    out = np.zeros(pos, np.uint32)
    out[:N] = head + 2 * S * (np.cumsum(new) - 1)
    out[head:head + ranges.size] = ranges.ravel()
    if pairs:
        out[head + ranges.size:] = np.concatenate(pairs)
    return torch.from_numpy(out.view(np.int32)).to(M.device)


def admm_members(sw, M: torch.Tensor) -> torch.Tensor:
    """``group_members(M)`` on M's device, built once for the prep ``sw``
    while M is the same tensor, unchanged in place (cached on the
    prep)."""
    key = ("k5_members", M.device)
    got = sw.cache.get(key)
    if got is not None and got[0] is M and got[1] == M._version:
        return got[2]
    lists = group_members(M)
    sw.cache[key] = (M, M._version, lists)
    return lists


def admm_constants(sw) -> dict:
    """K5's constants of the prep ``sw`` (``ops/stagewise.StagewiseQP``), in
    the kernel's layout, on the prep's device (built once, cached on the
    prep): J (m, b), and Mc (m, b), the stage rows' block on ξ_{k−1} for
    k ≥ 1 without the blocking rows (the dynamics' −A and the inequalities'
    E on x_k), whose −tie[k, j] on column blk[j] the kernel adds (tie
    (N, n_blk), blk (n_blk,) int32, blk0 their first row); rows (3, m, N):
    ρ, the soft rows' linear and quadratic penalties, by row then stage;
    with extra rows Aext (n_ext, N, b), KiU (N, b, n_ext), Cw and ρₑ; and
    above b = 16 the factors packed for the wide sweep (``pack_wide``) as
    "wide"."""
    key = ("k5", sw.device)
    got = sw.cache.get(key)
    if got is not None:
        return got
    nx, nc, nv, b, m = sw.nx, sw.nc, sw.nv, sw.b, sw.m_k
    opts = dict(dtype=torch.float32, device=sw.device)
    J = torch.zeros((m, b), **opts)
    J[:nx, :nv] = -sw.Bv
    J[:nx, nv:] = torch.eye(nx, **opts)
    J[nx:nx + nc, :nv] = sw.Fv
    i0 = nx + nc + b
    J[nx + nc:i0] = torch.eye(b, **opts)
    for j, cj in enumerate(sw.blk_cols):
        J[i0 + j, cj] = 1.0
    i1 = i0 + sw.n_blk
    J[i1:i1 + sw.n_term, nv:] = sw.Et
    J[i1 + sw.n_term:, :sw.n_cons] = torch.eye(sw.n_cons, **opts)
    Mc = torch.zeros((m, b), **opts)
    Mc[:nx, nv:] = -sw.A_dyn
    Mc[nx:nx + nc, nv:] = sw.E
    c = dict(J=J, Mc=Mc, blk0=i0,
             tie=sw.tie.float().contiguous() if sw.n_blk else None,
             blk=(torch.tensor(sw.blk_cols, dtype=torch.int32,
                               device=sw.device) if sw.n_blk else None),
             rows=torch.stack([sw.rho_rows.T, sw.soft_lin.T,
                               sw.soft_quad.T]).float().contiguous())
    if b > 16:
        c["wide"] = pack_wide(sw.factors)
    if sw.n_ext:
        c.update(Aext=sw.Aext.float().contiguous(),
                 KiU=sw.KiU.float().contiguous(),
                 Cw=sw.Cw.float().contiguous(),
                 rho_ext=sw.rho_ext.float().contiguous())
    sw.cache[key] = c
    return c


class _AdmmArgs(ctypes.Structure):
    """``struct PhcSwAdmmArgs`` of csrc/stagewise.cu, field by field."""

    _fields_ = (
        [(k, ctypes.c_void_p) for k in (
            "q", "l", "u", "x0", "z0", "y0", "ze0", "ye0", "ext_u", "L",
            "U", "C", "J", "Mc", "tie", "blk", "rows", "Aext", "KiU", "Cw",
            "rho_e", "gM", "x", "z", "y", "dy", "ze", "ye", "dye")]
        + [(k, ctypes.c_int) for k in (
            "P", "N", "b", "m", "S", "n_blk", "blk0", "n_ext", "n_cons",
            "mean", "iters")]
        + [(k, ctypes.c_float) for k in ("sigma", "alpha")]
        + [("ext_ws", ctypes.c_void_p), ("ext", ctypes.c_int),
           ("ring", ctypes.c_int), ("Pi", ctypes.c_void_p),
           ("Psi", ctypes.c_void_p), ("windows", ctypes.c_int)])


def par_maps(sw, windows: int, bmax: int):
    """(Π, Ψ) of the parallel sweep's ``windows`` windows over the prep
    ``sw`` (``ops/stagewise.window_maps`` of ``horizon_windows``), as the
    kernel reads them: row-major up to bmax 16, each block column-major
    above (cached on the prep)."""
    from pyhybridcontrol_tpu_torch.ops.stagewise import window_maps

    maps = window_maps(sw, horizon_windows(sw.N, windows))
    if bmax <= 16:
        return maps
    key = ("k5_par_maps", windows)
    got = sw.cache.get(key)
    if got is None:
        got = tuple(M.transpose(-1, -2).contiguous() for M in maps)
        sw.cache[key] = got
    return got


def admm_cluster_capacity(sw, args, pl: AdmmPlan) -> int:
    """Clusters of the FLEX plan ``pl`` the card holds at once
    (cudaOccupancyMaxActiveClusters for ``args``, the launch's
    ``_AdmmArgs``; memoized on the prep). Raises where it holds none or the
    query fails: such a plan cannot run, and nothing shrinks the cluster
    or falls back."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    key = ("k5_clusters", pl, args.N, args.m, args.n_blk, args.n_ext,
           args.n_cons)
    got = sw.cache.get(key)
    if got is None:
        lib = load_library(pl.library)
        got = _held(lib, lib.phc_sw_admm_max_clusters(
            ctypes.addressof(args), pl.warps, pl.tps, int(pl.staged),
            pl.bmax, pl.spc, pl.cluster, ADMM_PLACES[pl.variant],
            pl.lists), pl)
        sw.cache[key] = got
    return got


def _held(lib, got: int, pl: AdmmPlan) -> int:
    """An occupancy query's answer: raises on an error code, or where the
    card holds no cluster of ``pl``."""
    if got < 0:
        _raise_on(lib, -got, "K5 (stagewise ADMM) occupancy query")
    if got == 0:
        raise RuntimeError(
            f"K5 ({pl.variant}): the card holds no cluster of "
            f"{pl.cluster} CTAs of {32 * pl.warps} threads and "
            f"{pl.smem} bytes of shared memory")
    return got


def horizon_capacity(N: int, b: int, m: int, pl: AdmmPlan,
                     device=None) -> int:
    """Clusters of the horizon plan ``pl`` (horizon N, block b, m rows a
    stage) that the card ``device`` holds at once: cudaOccupancyMaxActive
    Clusters, read once per plan, shape and card. Raises where it holds
    none or the query fails."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    dev = torch.device("cuda" if device is None else device)
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    key = (dataclasses.replace(pl, parallel=False), N, b, m, index)
    got = _HORIZON_CAPACITY.get(key)
    if got is None:
        lib = load_library(pl.library)
        args = _AdmmArgs(P=1, N=N, b=b, m=m, S=1)
        with torch.cuda.device(index):
            got = _held(lib, lib.phc_sw_admm_horizon_max_clusters(
                ctypes.addressof(args), pl.warps, pl.tps, int(pl.staged),
                pl.bmax, pl.cluster), pl)
        _HORIZON_CAPACITY[key] = got
    return got


def _warn_waves(sw, pl: AdmmPlan, clusters: int, held: int) -> None:
    """Warns, once for the plan ``pl`` and this count on the prep ``sw``,
    where a launch's ``clusters`` exceed the ``held`` the card runs at
    once: the launch runs in more than one wave."""
    key = ("k5_waves", pl, clusters)
    if clusters <= held or key in sw.cache:
        return
    sw.cache[key] = True
    warnings.warn(
        f"K5 ({pl.variant}): {clusters} clusters of {pl.cluster} CTAs, the "
        f"card holds {held} at once: {-(-clusters // held)} waves",
        stacklevel=3)


def sw_admm_cuda(sw, q, l, u, x, z, y, z_e, y_e, ext_u, iters: int,
                 consensus_M=None, staged: Optional[bool] = None,
                 variant: Optional[str] = None,
                 runtime_r: Optional[bool] = None, parallel: bool = False,
                 tps: Optional[int] = None, spc: Optional[int] = None):
    """K5 on the card: ``iters`` stagewise ADMM iterations of the prep
    ``sw`` in one launch, from the warm carries. x and q (…, N, b), z, y,
    l and u (…, N, m_k) with one batch (z already inside [l, u]); with
    extra rows z_e, y_e and ext_u (…, n_ext); ``consensus_M`` (S, S, N)
    the group mean over the last batch axis (S scenarios); ``parallel``
    the parallel sweep (``_admm_iterations`` with ``_solve_K_windowed`` on
    the plan's windows is its plain version): in the horizon variant where
    the plan takes it;
    ``staged``, ``variant``, ``runtime_r``, ``tps`` and ``spc`` force one
    instantiation (``plan_admm``); ``parallel`` elsewhere the parallel
    sweep inside the variant the plan picks (``par_maps`` on the plan's
    windows). Returns (x, z, y, dy, z_e, y_e, dy_e)
    as ``ops/stagewise._admm_iterations`` does. Checks, allocates the
    outputs (and a FLEX variant's scratch, and the runtime-r vectors'
    where they lie in device memory), builds a FLEX variant's member
    lists of ``consensus_M`` once (``admm_members``), checks a FLEX cluster
    with a group mean against the card's occupancy, warns once a plan
    where its clusters (a horizon plan's P, a group mean's P/S) exceed what
    the card holds at once (more than one wave), and launches once."""
    from pyhybridcontrol_tpu_torch.ops._build import load_library

    dev = x.device
    if dev.type != "cuda":
        raise ValueError(f"K5: expected a CUDA tensor, got {dev}")
    N, b, m, r = sw.N, sw.b, sw.m_k, sw.n_ext
    batch = tuple(torch.broadcast_shapes(*(t.shape[:-2]
                                           for t in (q, l, u, x, z, y))))
    mean = consensus_M is not None and sw.n_cons > 0
    S = consensus_M.shape[0] if mean else 1
    if mean and batch[-1:] != (S,):
        raise ValueError(f"K5: the group mean runs over S={S} scenarios, "
                         f"the batch is {batch}")
    P = int(np.prod(batch)) if batch else 1

    def flat(name, t, tail):
        t = t.expand(batch + tail).reshape((P,) + tail)
        t = t.to(torch.float32).contiguous()
        _check(name, t, (P,) + tail, dev)
        return t

    q, x0 = flat("q", q, (N, b)), flat("x", x, (N, b))
    l, u, z0, y0 = (flat(k, t, (N, m)) for k, t in
                    (("l", l), ("u", u), ("z", z), ("y", y)))
    c = admm_constants(sw)
    for name, f in zip(("L", "Uinv", "C"), sw.factors):
        _check(name, f, (N, b, b), dev)
    gM = consensus_M.float().contiguous() if mean else None
    if mean:
        _check("consensus_M", gM, (S, S, N), dev)
    members = admm_members(sw, gM) if mean else None
    pl = plan_admm(P, N, b, m, S, sw.n_blk, r, sw.n_cons, mean, staged,
                   variant, runtime_r, parallel, tps, dev,
                   0 if members is None else members.numel(), spc)
    out = [torch.empty((P, N, b), dtype=torch.float32, device=dev)]
    out += [torch.empty((P, N, m), dtype=torch.float32, device=dev)
            for _ in range(3)]
    ext = dict(ze0=None, ye0=None, ext_u=None, ze=None, ye=None, dye=None)
    if r:
        ext.update(ze0=flat("z_e", z_e, (r,)), ye0=flat("y_e", y_e, (r,)),
                   ext_u=flat("ext_u", ext_u, (r,)))
        ext.update({k: torch.empty((P, r), dtype=torch.float32, device=dev)
                    for k in ("ze", "ye", "dye")})
    ext_ws = (torch.empty(P * ext_scratch_words(r), dtype=torch.float32,
                          device=dev) if pl.ext & EXT_VEC else None)
    LUC = c["wide"].unbind(0) if pl.bmax > 16 else sw.factors
    Pi, Psi = (par_maps(sw, pl.windows, pl.bmax) if pl.windows > 1
               else (None, None))
    ptrs = dict(q=q, l=l, u=u, x0=x0, z0=z0, y0=y0, L=LUC[0], U=LUC[1],
                C=LUC[2], J=c["J"], Mc=c["Mc"], tie=c["tie"], blk=c["blk"],
                rows=c["rows"], Aext=c.get("Aext"), KiU=c.get("KiU"),
                Cw=c.get("Cw"), rho_e=c.get("rho_ext"), gM=gM, x=out[0],
                z=out[1], y=out[2], dy=out[3], ext_ws=ext_ws, Pi=Pi, Psi=Psi,
                **ext)
    args = _AdmmArgs(**{k: _ptr(v).value for k, v in ptrs.items()},
                     P=P, N=N, b=b, m=m, S=S, n_blk=sw.n_blk,
                     blk0=c["blk0"], n_ext=r, n_cons=sw.n_cons,
                     mean=int(mean), iters=int(iters), sigma=sw.sigma,
                     alpha=sw.alpha, ext=pl.ext, ring=pl.ring,
                     windows=pl.windows)
    lib = load_library(pl.library)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if pl.variant == "shared":
            rc = lib.phc_sw_admm(ctypes.addressof(args), pl.warps, pl.tps,
                                 int(pl.staged), pl.bmax,
                                 ctypes.c_void_p(stream))
        elif pl.variant == "horizon":
            from pyhybridcontrol_tpu_torch.ops.stagewise import window_maps

            maps = (window_maps(sw, horizon_windows(N, pl.cluster))
                    if pl.parallel else (None, None))
            _warn_waves(sw, pl, P, horizon_capacity(N, b, m, pl, dev))
            rc = lib.phc_sw_admm_horizon(
                ctypes.addressof(args), _ptr(maps[0]), _ptr(maps[1]),
                pl.warps, pl.tps, int(pl.staged), pl.bmax, pl.cluster,
                int(pl.parallel), ctypes.c_void_p(stream))
        else:
            place = ADMM_PLACES[pl.variant]
            if mean:
                _warn_waves(sw, pl, P // S,
                            admm_cluster_capacity(sw, args, pl))
            scratch = torch.empty(
                P * flex_scratch_words(N, b, m, sw.n_cons, mean, place,
                                       pl.bmax)
                if place else 0, dtype=torch.float32, device=dev)
            rc = lib.phc_sw_admm_flex(
                ctypes.addressof(args), pl.warps, pl.tps, int(pl.staged),
                pl.bmax, pl.spc, pl.cluster, place,
                _ptr(scratch if place else None), _ptr(members), pl.lists,
                ctypes.c_void_p(stream))
    _raise_on(lib, rc, f"K5 (stagewise ADMM, {pl.variant}"
              + (", parallel sweep)" if pl.windows else ")"))
    _count_launch(pl.launch, P)
    shapes = ((N, b), (N, m), (N, m), (N, m))
    res = [t.reshape(batch + sh) for t, sh in zip(out, shapes)]
    if r:
        res += [ext[k].reshape(batch + (r,)) for k in ("ze", "ye", "dye")]
    else:
        res += [None, None, None]
    return tuple(res)
