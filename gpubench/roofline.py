"""The yardstick: the card's peaks and the bytes the algorithm must move.

Peaks are NVIDIA's data sheet for the H100 SXM (80 GB HBM3 at 3.35 TB/s)
and the host link's nominal rate (PCIe Gen5 x16, 64 GB/s each way). Every
count below is a lower bound on what the work must move: each input read
once and each output written once, whatever a kernel reads again. A
share of a peak built on them can only read low, never above 100%.
"""

from __future__ import annotations

from dataclasses import dataclass

HBM_BYTES_PER_S = 3.35e12
HOST_LINK_BYTES_PER_S = 64e9
ID_BYTES = 4          # int32 row, column and segment ids


def k1_bytes(T: int, S: int, rows: int, L: int, itemsize: int = 4,
             out_itemsize: int = 4) -> int:
    """One K1 call over a sorted tail stream of T entries (value, gather
    id, segment id) into L lanes of S segments, gathering an (L, rows)
    operand: the stream, the operand's rows it can touch (at most T), and
    the (L, S) output."""
    return (T * (itemsize + 2 * ID_BYTES) + L * min(T, rows) * itemsize
            + L * S * out_itemsize)


def k1_bound_s(T: int, S: int, rows: int, L: int, itemsize: int = 4) -> float:
    return k1_bytes(T, S, rows, L, itemsize) / HBM_BYTES_PER_S


@dataclass(frozen=True)
class ProblemShape:
    """One x-update solve: R rows over N = B n coefficients, a dense head
    of H columns per block stored in head_itemsize bytes, T tail entries,
    L lambda lanes, compute in itemsize bytes."""

    R: int
    N: int
    T: int
    H: int
    L: int
    head_itemsize: int
    itemsize: int = 4


def pass_bytes(p: ProblemShape) -> int:
    """One data pass (X v or X' d) over a problem: the head in its dtype,
    one tail stream (value and two ids), the three row vectors (label,
    weight, offset), the (R, L) and the (N, L) vector."""
    return (p.R * p.H * p.head_itemsize
            + p.T * (p.itemsize + 2 * ID_BYTES)
            + 3 * p.R * p.itemsize
            + p.R * p.L * p.itemsize
            + p.N * p.L * p.itemsize)


def passes(newton_trips: int, cg_trips: int) -> int:
    """Data passes a solve needs: each CG trip is one Hessian product
    (X d, then X' of it) and each Newton trip one objective, gradient and
    diagonal (X w, then X' of it): two passes a trip."""
    return 2 * (int(newton_trips) + int(cg_trips))


def step_least_s(shapes: list[ProblemShape], trips: list[tuple[int, int]],
                 wire_bytes: int = 0) -> float:
    """The least time of one ADMM iteration: the larger of its passes'
    bytes over the HBM rate and its host-to-device bytes over the host
    link. `trips[i]` is (Newton, CG) of problem i."""
    hbm = sum(passes(*t) * pass_bytes(s) for s, t in zip(shapes, trips))
    return max(hbm / HBM_BYTES_PER_S, wire_bytes / HOST_LINK_BYTES_PER_S)
