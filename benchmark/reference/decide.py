"""Plain reference of BELLA's decision and its M4 rows.

A pair passes when its alignment score reaches the adaptive threshold
of BELLA's Chernoff bound (bioRxiv 10.1101/464420, section 2.3; its
PostAlignDecision):

    score >= (1 - delta) * phi * ov,  phi = p - (1 - p), p = (1 - e)^2,
    ov = min(beg_v, beg_h) + min(len_v - end_v, len_h - end_h)
         + (aligned_v + aligned_h) // 2,

and a passing pair is one M4 row, tab-separated: nameV nameH count score
ov strand(n|c) begV endV lenV begH endH lenH.
"""

from __future__ import annotations

import numpy as np


def decide(score, beg_h, end_h, beg_v, end_v, len_h, len_v, error_rate,
           delta):
    """(passed, ov) of aligned pairs."""
    score, beg_h, end_h, beg_v, end_v, len_h, len_v = (
        np.asarray(a, np.int64)
        for a in (score, beg_h, end_h, beg_v, end_v, len_h, len_v))
    ov = (np.minimum(beg_v, beg_h) + np.minimum(len_v - end_v, len_h - end_h)
          + ((end_v - beg_v) + (end_h - beg_h)) // 2)
    p = (1.0 - error_rate) ** 2
    phi = p - (1.0 - p)
    passed = score.astype(np.float64) >= (1.0 - delta) * (
        phi * ov.astype(np.float64))
    return passed, ov


def m4_lines(names, lengths, read_h, read_v, count, score, ov, rc, beg_v,
             end_v, beg_h, end_h) -> list:
    """The M4 rows (bytes, newline-terminated) of the given pairs."""
    cols = [np.asarray(a).tolist() for a in (
        read_h, read_v, count, score, ov, rc, beg_v, end_v, beg_h, end_h)]
    lens = np.asarray(lengths).tolist()
    return [
        (f"{names[v]}\t{names[h]}\t{c}\t{s}\t{o}\t{'c' if r else 'n'}\t"
         f"{bv}\t{ev}\t{lens[v]}\t{bh}\t{eh}\t{lens[h]}\n").encode()
        for h, v, c, s, o, r, bv, ev, bh, eh in zip(*cols)
    ]
