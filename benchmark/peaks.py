"""Published peaks of the cards the benchmark runs on, and the least time
the alignment work needs on one.

NVIDIA H100 SXM data sheet, at its 700 W limit: 3.35 TB/s of HBM3, and
67 T/s of 32-bit operations outside the tensor cores (its float32 rate;
the sheet has no int32 row, so the float32 peak bounds the int32 rate
from above and the least time stays a lower bound).
"""

from __future__ import annotations

from typing import Optional

PEAKS = {
    "H100": dict(hbm_bytes_per_s=3.35e12, ops_per_s=67e12),
}
# int32 operations of one band cell of an x-drop antidiagonal: a compare,
# two adds and two maxima
OPS_PER_CELL = 5


def peaks(kind: str) -> Optional[dict]:
    """The peaks of the card named `kind` (torch.cuda.get_device_name),
    or None for a card the table does not hold."""
    for key, p in PEAKS.items():
        if key in (kind or ""):
            return p
    return None


def xdrop_least_s(aligned_bases: int, band: int, packed_bytes: int,
                  kind: str) -> Optional[float]:
    """The least time x-drop alignment of these outputs needs: the larger
    of OPS_PER_CELL operations on each of `band` cells of every
    antidiagonal the outputs cover (one an aligned base: the sum over
    pairs of end_h - beg_h + end_v - beg_v) at the operation peak, and the
    2-bit packed reads read once at the memory peak. It reads only the
    outputs, the configured band and the reads, so it is the same
    whatever kernel computes them."""
    p = peaks(kind)
    if p is None:
        return None
    return max(OPS_PER_CELL * band * aligned_bases / p["ops_per_s"],
               packed_bytes / p["hbm_bytes_per_s"])
