"""K1 and K5: per-lead z-score, CUDA kernels + plain PyTorch versions.

K1 replaces ``ptbxl_tpu/ops/pallas/zscore.py``: ``zscore_tile`` (:44),
``_zscore_kernel`` (:59) and ``zscore_pallas`` (:64, pallas_call :72).
K5 replaces ``_zscore_wide_kernel`` (:82) and ``zscore_pallas_wide`` (:107,
pallas_call :130): the same function on a ``[T*C/W, W]`` view of each
record.  Kernels: ``ptbxl_torch/csrc/zscore.cu``.

What bounds it on the H100: bytes (one read of the input, one write of the
output, a few operations an element).  The design (each record read from
device memory once, by bulk copies, into the shared memory of one
thread-block cluster's k CTAs; the two moments folded across the cluster
in f64, in rank order, through distributed shared memory; the output
written from shared memory by a bulk store) is described in the source.
``cluster_plan`` computes each launch's plan (k, the piece a CTA holds,
threads, shared memory), which the C entries check; a launch the card
refuses raises.  ``zscore_cluster_plain`` emulates the kernel's fold (per
piece f64 totals, added in rank order) on the plan's pieces.

``zscore`` maps ``[B, T, C]`` to the same shape, f32 sums, output dtype =
input dtype unless ``out_dtype`` says otherwise (f32 and bf16).
``zscore_stats`` writes only ``[B, C, 2]`` = (mean, std + 1e-6); the fused
ECGCNN forward applies it while loading block 0.

``zscore_wide`` (K5) computes what ``zscore`` computes, with the argument
checks of the JAX function (``width`` divides T*C and is a multiple of C),
``width`` (default 480) and ``block_b`` (default 8).  On the card pieces
hold whole rows of ``width``, a CTA walks its piece in lines of whole rows
(where a row's 16-byte vectors fit in one CTA's threads) and a cluster takes
``block_b`` records in turn; the ragged last group is masked, so B is not
padded.
``zscore_wide_plain`` follows the JAX kernel's arithmetic on the view: B
padded to a multiple of ``block_b``, per-slot sums folded by lead.

A CPU tensor takes the plain version; a CUDA tensor launches the kernel or
raises.  ``launches`` counts K1 launches (both entries), ``launches_wide``
K5 launches.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from ptbxl_torch.ops.kernels import _build
from ptbxl_torch.ops.preprocess import EPS

launches = 0
launches_wide = 0

# every entry: (device, x, out, B, T, C, ..., the plan: a pointer to
# ClusterPlan.c_args() as 10 ints, stream)
_I, _P = _build.INT, _build.VOIDP
LIB = _build.Library("zscore", {
    # x, out, B, T, C, in_bf16, out_bf16, plan
    "ptbxl_zscore": [_P, _P] + [_I] * 5 + [_P],
    # x, stats, B, T, C, in_bf16, plan
    "ptbxl_zscore_stats": [_P, _P] + [_I] * 4 + [_P],
    # x, out, B, T, C, W, block_b, in_bf16, out_bf16, plan
    "ptbxl_zscore_wide": [_P, _P] + [_I] * 7 + [_P],
})
_DTYPES = (torch.float32, torch.bfloat16)


def _moments(xf: torch.Tensor):
    """Two-pass per-lead mean and ``sqrt(var) + eps`` of an f32 [B, T, C].

    The f32 form of ``zscore_tile``: f32 addends (x, and the f32 square of
    x - mean), totals rounded to f32 before the division by T.  The totals
    are accumulated in f64, as the kernel does, so neither side loses bits
    to its summation order when a lead's DC offset is large beside its std.
    T is a tensor on the data's device: PyTorch's CUDA division by a host
    scalar multiplies by its reciprocal, which can be 1 ulp off the kernel's
    IEEE division.
    """
    t = xf.new_tensor(float(xf.shape[1]))
    mean = xf.sum(dim=1, keepdim=True, dtype=torch.float64).float() / t
    cen = xf - mean
    sq = (cen * cen).sum(dim=1, keepdim=True, dtype=torch.float64).float()
    sd = torch.sqrt(sq / t) + EPS
    return mean, sd


def zscore_stats_plain(x: torch.Tensor) -> torch.Tensor:
    """[B, T, C] -> [B, C, 2] f32: (mean, std + eps)."""
    mean, sd = _moments(x.float())
    return torch.stack([mean[:, 0], sd[:, 0]], dim=-1)


def zscore_plain(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Plain form of the kernel: ``zscore_tile`` on each record, f32 inside."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    xf = x.float()
    mean, sd = _moments(xf)
    return ((xf - mean) / sd).to(out_dtype)


# -- the launch plan --------------------------------------------------------------

MAX_SMEM = 232448        # dynamic shared memory a CTA can have (bytes)
MAX_CLUSTER = 16         # CTAs a cluster (above 8: non-portable sizes, by request only)
PORTABLE_CLUSTER = 8
MAX_THREADS = 256        # the kernel's launch bound (with 3 CTAs an SM: 80 registers)
# Tuned on the H100 (tools/probe_zscore.py --sweep): a cluster has the fewest
# CTAs (a power of two, at most 8) whose pieces stay within PIECE_BYTES, so
# that some six CTAs of 128 threads stay resident on an SM and cover each
# other's loads and exchanges.  At [5000, 12]: k = 8 for f32 (30 KB pieces),
# 4 for bf16.  One piece buffer a CTA: a second one, to read the next record
# while this one finishes, halves the CTAs an SM and measured slower.  Both
# K1 entries take the same k at the same shape, so zscore_stats gives
# zscore's mean and sd bit for bit.
PIECE_BYTES = 32 * 1024
THREADS = 128            # threads a CTA (a target: whole vectors of a row or a lead's period)
PER_K1 = 1               # records a K1 cluster takes in turn


class ClusterPlan(NamedTuple):
    """One launch of the z-score cluster kernel (``csrc/zscore.cu``)."""
    k: int            # CTAs a cluster: the ranks a record is split over
    row: int          # elements a row: C (K1) or width (K5); pieces start on whole rows
    piece_rows: int   # rows a rank; the last rank takes the rest
    per: int          # records a cluster takes in turn (K5: block_b)
    threads: int      # threads a CTA
    walkers: int      # threads that walk the piece, 16 bytes each a step
    lanes: int        # min(32, C / gcd(C, VE)): lanes of a warp holding distinct leads
    buf_bytes: int    # a piece buffer: the largest piece + its alignment pad
    stage_bytes: int  # the output staging buffer (0: the output is written in place)
    bulk_bytes: int   # the largest bulk copy of a piece (a multiple of 16)
    smem_bytes: int   # dynamic shared memory a CTA
    clusters: int     # clusters of the grid

    def c_args(self) -> Tuple[int, ...]:
        return (self.k, self.piece_rows, self.per, self.threads, self.walkers, self.lanes,
                self.buf_bytes, self.stage_bytes, self.bulk_bytes, self.smem_bytes)


@functools.lru_cache(maxsize=256)
def _c_plan(plan: ClusterPlan) -> ctypes.Array:
    """``plan.c_args()`` as C ints, built once a plan (the cache keeps it alive)."""
    args = plan.c_args()
    return (ctypes.c_int * len(args))(*args)


def _size(dtype: torch.dtype) -> int:
    return torch.empty((), dtype=dtype).element_size()


def _padded(nbytes: int) -> int:
    """A buffer for ``nbytes`` that keeps its source's address modulo 16."""
    return (nbytes + 16 + 15) // 16 * 16


@functools.lru_cache(maxsize=256)
def cluster_plan(B: int, T: int, C: int, width: int, in_dtype: torch.dtype,
                 out_dtype: Optional[torch.dtype], entry: str, k: Optional[int] = None,
                 per: Optional[int] = None, threads: Optional[int] = None) -> ClusterPlan:
    """The launch plan of one entry (``zscore``, ``zscore_stats``, ``zscore_wide``).

    ``width`` is the row a piece holds whole rows of: C for the K1 entries,
    the K5 width.  ``k``, ``per`` (K1 only; K5 takes ``block_b`` as ``per``)
    and ``threads`` (a target, at most 256) override the tuned choices, for
    the probes; ``out_dtype`` is ignored by ``zscore_stats``.  Raises
    ``ValueError`` where no cluster of at most 16 CTAs holds a record.
    """
    if entry not in ("zscore", "zscore_stats", "zscore_wide"):
        raise ValueError(f"unknown entry {entry!r}")
    family = "k5" if entry == "zscore_wide" else "k1"
    if family == "k1" and width != C:
        raise ValueError(f"the K1 entries take rows of C={C}, got width {width}")
    if B < 1 or T < 1 or C < 1 or (T * C) % width or width % C:
        raise ValueError(f"bad shape B={B} T={T} C={C} width={width}")
    in_size = _size(in_dtype)
    out_size = in_size if entry == "zscore_stats" else _size(out_dtype or in_dtype)
    ve = 16 // in_size
    nrows = (T * C) // width
    if family == "k1":
        per = max(1, min(PER_K1 if per is None else per, B))
    elif per is None or per < 1:
        raise ValueError(f"zscore_wide takes block_b >= 1 as per, got {per}")
    if k is None:
        k = 1
        while k < PORTABLE_CLUSTER and -(-nrows // k) * width * in_size > PIECE_BYTES:
            k *= 2
    # walkers * VE: a multiple of the row where its vectors fit in one CTA, else of C
    unit = width // math.gcd(width, ve)
    if unit > MAX_THREADS:
        unit = C // math.gcd(C, ve)
    if unit > MAX_THREADS:
        raise ValueError(f"C={C}: a lead's period of {unit} vectors exceeds {MAX_THREADS} threads")
    lanes = min(32, C // math.gcd(C, ve))
    target = THREADS if threads is None else max(32, min(threads, MAX_THREADS))
    while True:
        k = max(1, min(k, nrows, MAX_CLUSTER))
        piece_rows = -(-nrows // k)
        k = -(-nrows // piece_rows)  # no rank without rows
        piece = piece_rows * width
        groups = piece * in_size // 16
        walkers = unit * max(1, min(target // unit, -(-groups // unit)))
        nthreads = -(-walkers // 32) * 32
        buf_bytes = _padded(piece * in_size)
        stage_bytes = 0 if out_size == in_size else _padded(piece * out_size)
        # the piece, the output's staging buffer, the fold's scratch, the two
        # passes' inboxes of k totals, three mbarriers, the moments and the
        # reciprocals of the sd
        smem = (buf_bytes + stage_bytes + (nthreads // 32) * lanes * ve * 8 + 2 * k * C * 8
                + 3 * 8 + 3 * C * 4)
        if smem <= MAX_SMEM:
            break
        if k >= min(nrows, MAX_CLUSTER):
            raise ValueError(f"a record of T={T} C={C} does not fit the shared memory of "
                             f"{k} CTAs ({smem} bytes a CTA)")
        k *= 2
    return ClusterPlan(k=k, row=width, piece_rows=piece_rows, per=per,
                       threads=nthreads, walkers=walkers, lanes=lanes, buf_bytes=buf_bytes,
                       stage_bytes=stage_bytes, bulk_bytes=(piece * in_size) & ~15,
                       smem_bytes=smem, clusters=-(-B // per))


def plan_pieces(plan: ClusterPlan, T: int, C: int) -> List[Tuple[int, int]]:
    """(first element, elements) of each rank's piece of a flat record of T*C."""
    nrows = (T * C) // plan.row
    out = []
    for r in range(plan.k):
        r0 = r * plan.piece_rows
        out.append((r0 * plan.row, (min(r0 + plan.piece_rows, nrows) - r0) * plan.row))
    return out


def piece_split(addr: int, n: int, size: int) -> Tuple[int, int, int]:
    """How the kernel reads (or writes) n elements of ``size`` bytes at byte
    address ``addr``: (head elements by ordinary loads, bulk bytes by one bulk
    copy from the first 16-byte boundary, a multiple of 16, tail elements by
    ordinary loads).  ``split`` in ``csrc/zscore.cu``."""
    head = min(n, ((16 - addr % 16) % 16) // size)
    rem = n - head
    bulk = (rem * size) & ~15
    return head, bulk, rem - bulk // size


def zscore_cluster_plain(x: torch.Tensor, plan: ClusterPlan,
                         out_dtype: Optional[torch.dtype] = None,
                         stats: bool = False) -> torch.Tensor:
    """The cluster kernel's arithmetic on the plan's pieces: each rank's per-lead
    totals in f64, added in rank order 0..k-1, rounded to f32 before the
    division by T; the output (or ``[B, C, 2]`` stats when ``stats``) as
    ``zscore_plain``."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, t, c = x.shape
    xf = x.float().reshape(b, t * c)
    pieces = plan_pieces(plan, t, c)

    def totals(v: torch.Tensor) -> torch.Tensor:  # [B, T*C] f32 -> [B, C] f64
        tot = v.new_zeros((b, c), dtype=torch.float64)
        for start, n in pieces:
            tot = tot + v[:, start:start + n].reshape(b, n // c, c).sum(dim=1, dtype=torch.float64)
        return tot

    tt = xf.new_tensor(float(t))
    mean = totals(xf).float() / tt
    cen = xf.view(b, t, c) - mean[:, None, :]
    sd = torch.sqrt(totals((cen * cen).reshape(b, t * c)).float() / tt) + EPS
    if stats:
        return torch.stack([mean, sd], dim=-1)
    return (cen / sd[:, None, :]).to(out_dtype)


def _check_input(x: torch.Tensor) -> None:
    if x.dim() != 3:
        raise ValueError(f"expected [B, T, C], got shape {tuple(x.shape)}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"zscore kernel takes float32 or bfloat16, got {x.dtype}")
    if x.device.type != "cuda":
        raise RuntimeError(f"zscore kernel needs a CUDA tensor, got {x.device}")


def launch_plan(x: torch.Tensor, plan: ClusterPlan, entry: str,
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Launch one entry of the cluster kernel with ``plan`` on a contiguous CUDA
    ``x`` of at least one record: ``zscore`` and ``zscore_wide`` (rows of
    ``plan.row``, ``plan.per`` records a cluster: K5's ``block_b``) return the
    output, ``zscore_stats`` the ``[B, C, 2]`` stats.  The wrappers call it
    with ``cluster_plan``'s choice, the probes with others; every launch
    counts (``launches``, K5's ``launches_wide``)."""
    global launches, launches_wide
    b, t, c = x.shape
    out_dtype = x.dtype if out_dtype is None else out_dtype
    shape = (b, c, 2) if entry == "zscore_stats" else (b, t, c)
    out = torch.empty(shape, dtype=torch.float32 if entry == "zscore_stats" else out_dtype,
                      device=x.device)
    in_bf16, out_bf16 = int(x.dtype == torch.bfloat16), int(out_dtype == torch.bfloat16)
    c_plan = ctypes.addressof(_c_plan(plan))
    if entry == "zscore":
        LIB.launch("ptbxl_zscore", x, out, b, t, c, in_bf16, out_bf16, c_plan)
    elif entry == "zscore_stats":
        LIB.launch("ptbxl_zscore_stats", x, out, b, t, c, in_bf16, c_plan)
    else:
        LIB.launch("ptbxl_zscore_wide", x, out, b, t, c, plan.row, plan.per, in_bf16, out_bf16,
                   c_plan)
    if entry == "zscore_wide":
        launches_wide += 1
    else:
        launches += 1
    return out


def zscore(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """x: [B, T, C] -> per-lead z-scored, f32 accumulation."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return zscore_plain(x, out_dtype)
    _check_input(x)
    if out_dtype not in _DTYPES:
        raise TypeError(f"zscore kernel writes float32 or bfloat16, got {out_dtype}")
    x = x.contiguous()
    b, t, c = x.shape
    if b == 0:
        return torch.empty((b, t, c), dtype=out_dtype, device=x.device)
    return launch_plan(x, cluster_plan(b, t, c, c, x.dtype, out_dtype, "zscore"), "zscore",
                       out_dtype)


def zscore_stats(x: torch.Tensor) -> torch.Tensor:
    """x: [B, T, C] -> [B, C, 2] f32 (mean, std + 1e-6) per record and lead."""
    if x.device.type == "cpu":
        return zscore_stats_plain(x)
    _check_input(x)
    x = x.contiguous()
    b, t, c = x.shape
    if b == 0:
        return torch.empty((b, c, 2), dtype=torch.float32, device=x.device)
    return launch_plan(x, cluster_plan(b, t, c, c, x.dtype, None, "zscore_stats"),
                       "zscore_stats")


def _check_wide(x: torch.Tensor, width: int, block_b: int) -> None:
    """The JAX function's argument checks (zscore.py:123-124), and ``block_b`` >= 1."""
    if x.dim() != 3:
        raise ValueError(f"expected [B, T, C], got shape {tuple(x.shape)}")
    _, t, c = x.shape
    if width <= 0 or (t * c) % width or width % c:
        raise ValueError(f"width {width} must divide T*C={t * c} and be a multiple of C={c}")
    if block_b < 1:
        raise ValueError(f"block_b must be >= 1, got {block_b}")


def _fold_leads(slot_sums: torch.Tensor, c: int) -> torch.Tensor:
    """[B, W] per-slot totals -> [B, W]: each slot gets its lead's total (slot l is lead l % C)."""
    b, w = slot_sums.shape
    lead = slot_sums.view(b, w // c, c).sum(dim=1)  # [B, C]
    return lead.repeat(1, w // c)


def zscore_wide_plain(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None,
                      width: int = 480, block_b: int = 8) -> torch.Tensor:
    """Plain form of K5: ``_zscore_wide_kernel`` on the ``[B, T*C/W, W]`` view.

    f32 addends, per-slot sums over the rows, folded by lead (the TPU kernel's
    ``[W, W]`` 0/1 product), totals in f64 and rounded to f32 before the
    division by T, as ``zscore_plain``.
    """
    _check_wide(x, width, block_b)
    out_dtype = x.dtype if out_dtype is None else out_dtype
    b, t, c = x.shape
    bp = -(-b // block_b) * block_b
    xw = x.float().reshape(b, (t * c) // width, width)
    if bp != b:
        xw = torch.cat([xw, xw.new_zeros((bp - b,) + xw.shape[1:])])
    tt = xw.new_tensor(float(t))
    mean = _fold_leads(xw.sum(dim=1, dtype=torch.float64), c).float() / tt
    cen = xw - mean[:, None, :]
    sq = _fold_leads((cen * cen).sum(dim=1, dtype=torch.float64), c).float()
    sd = torch.sqrt(sq / tt) + EPS
    return (cen / sd[:, None, :]).to(out_dtype)[:b].reshape(b, t, c)


def zscore_wide(x: torch.Tensor, out_dtype: Optional[torch.dtype] = None, width: int = 480,
                block_b: int = 8) -> torch.Tensor:
    """x: [B, T, C] -> per-lead z-scored (K5), f32 accumulation; out dtype = x's unless given."""
    out_dtype = x.dtype if out_dtype is None else out_dtype
    if x.device.type == "cpu":
        return zscore_wide_plain(x, out_dtype, width, block_b)
    _check_input(x)
    _check_wide(x, width, block_b)
    if out_dtype not in _DTYPES:
        raise TypeError(f"zscore kernel writes float32 or bfloat16, got {out_dtype}")
    x = x.contiguous()
    b, t, c = x.shape
    if b == 0:
        return torch.empty((b, t, c), dtype=out_dtype, device=x.device)
    plan = cluster_plan(b, t, c, width, x.dtype, out_dtype, "zscore_wide", per=block_b)
    return launch_plan(x, plan, "zscore_wide", out_dtype)
