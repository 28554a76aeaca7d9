"""Plain reference of seed-and-extend alignment, one pair at a time, in
numpy.

An extension runs the x-drop rule (Zhang et al. 2000, as BELLA's SeqAn
``extendSeed``): antidiagonal d of the dynamic-programming matrix of
target T against query Q (match +1, mismatch -1, gap -1) is computed in
a band of W cells, i + j = d, from i = lo on; the best cell so far is
kept, and the extension stops when an antidiagonal's best falls more
than xdrop below it, or at the matrix's end. The band is either static,
centred on the main diagonal (lo = max(0, (d - W + 1) >> 1)), or
adaptive: it moves one cell towards T whenever the antidiagonal's best
lies past its middle.

A pair extends left (both reads reversed from the seed's end) and right
(both from the seed's end on); H is reverse-complemented when the
seed's strands differ. bella_tpu's static path (aligner_backend "auto")
runs the static band W first; a pair whose extension drifted to the
band's edge (|t_end - q_end| >= W/2 - 2) re-extends at 2W, 4W, ... up to
the rescue ceiling, routed by the drift predictor, keeping the best
score over the bands it visits, and a pair still at the edge of the
widest band re-extends once through the adaptive band; its adaptive path
("jax") runs the adaptive band on every pair. Each pair's result depends
on that pair alone.

Every array here is numpy; ``align_pairs`` spreads pairs over worker
processes.
"""

from __future__ import annotations

import numpy as np

NINF = -(1 << 20)
ADAPTIVE = 0  # align_pair's `ended` where the adaptive band ended a route
MATCH, MISMATCH, GAP = 1, -1, -1
_PAD = 2      # the band's shifts between antidiagonals are within +-2
_T_PAD = 255  # never equals a base code
_Q_PAD = 254


def extend(t: np.ndarray, q: np.ndarray, xdrop: int, W: int,
           adaptive: bool):
    """One x-drop extension of target t against query q (uint8 base
    codes). Returns (score, t_end, q_end): the best cell's value and
    coordinates."""
    tl, ql = len(t), len(q)
    # tp[i] = t[i - 1] for i >= 1; rq[x] = q[j - 1] at x = ql + 1 - j, so
    # that q's bases along a band (j falling as i rises) read forwards
    tp = np.full(tl + W + 2, _T_PAD, np.int16)
    tp[1:tl + 1] = t
    rq = np.full(ql + W + 4, _Q_PAD, np.int16)
    rq[1:ql + 1] = q[::-1]
    a1 = np.full(W + 2 * _PAD, NINF, np.int64)
    a2 = a1.copy()
    a1[_PAD] = 0
    if ql >= 1:
        a2[_PAD] = GAP
    if tl >= 1:
        a2[_PAD + 1] = GAP
    lo_m2 = lo_m1 = lo = 0
    best = best_t = best_q = 0
    alive = tl + ql > 0
    d = 2
    while alive:
        if not adaptive:
            lo = max(0, (d - W + 1) >> 1)
        a3 = np.full(W + 2 * _PAD, NINF, np.int64)
        # lanes p with 0 <= j <= ql, i <= tl (i = lo + p, j = d - i)
        pa = max(0, d - ql - lo)
        pb = min(W - 1, tl - lo, d - lo)
        if pa <= pb:
            s1 = _PAD + lo - lo_m2 - 1
            s2 = _PAD + lo - lo_m1 - 1
            diag = a1[s1 + pa:s1 + pb + 1]
            gq = a2[s2 + pa:s2 + pb + 1]
            gt = a2[s2 + 1 + pa:s2 + pb + 2]
            i0 = lo + pa
            x0 = ql + 1 - (d - i0)  # rq index of q[j - 1] at lane pa
            n = pb - pa + 1
            # i = 0 or j = 0: no base pair there; the pads never compare
            # equal
            same = tp[i0:i0 + n] == rq[x0:x0 + n]
            sub = np.where(same, MATCH, MISMATCH)
            seg = np.maximum(diag + sub, np.maximum(gq, gt) + GAP)
            if adaptive:
                np.maximum(seg, NINF, out=seg)
            a3[_PAD + pa:_PAD + pb + 1] = seg
        band = a3[_PAD:_PAD + W]
        argp = int(band.argmax())
        cur = int(band[argp])
        if cur > best:
            best, best_t, best_q = cur, lo + argp, d - (lo + argp)
        alive = cur >= best - xdrop and d < tl + ql
        lo_m2, lo_m1 = lo_m1, lo
        if adaptive and alive and argp > W // 2:
            lo += 1
        a1, a2 = a2, a3
        d += 1
    return best, best_t, best_q


def static_band(band: int) -> int:
    """The static band: a multiple of 128, at least 128."""
    return max(128, -(-int(band) // 128) * 128)


def _comp(x: np.ndarray) -> np.ndarray:
    return (3 - x).astype(np.uint8)


def extend_pair(h: np.ndarray, v: np.ndarray, pos_h: int, pos_v: int,
                rc: bool, k: int, xdrop: int, W: int, adaptive: bool):
    """Both extensions of one pair from its seed. Returns (score, beg_h,
    end_h, beg_v, end_v, drift); H coordinates are on the reverse
    complement of h when rc."""
    hh = _comp(h[::-1]) if rc else h
    seh = (len(h) - pos_h - k if rc else pos_h) + k
    sev = pos_v + k
    ls, lt, lq = extend(hh[:seh][::-1], v[:sev][::-1], xdrop, W, adaptive)
    rs, rt, rq = extend(hh[seh:], v[sev:], xdrop, W, adaptive)
    return (ls + rs, seh - lt, seh + rt, sev - lq, sev + rq,
            max(abs(lt - lq), abs(rt - rq)))


def predict_due(sat: float, e_obs: float, e_pred: float, base: int,
                ceiling: int) -> int:
    """The band at which the drift predictor routes a pair into the
    cascade: a pair cut short (e_obs under 3/4 of its overlap estimate)
    extrapolates its drift over the whole overlap and goes to the
    smallest band whose half-width exceeds it; a censored pair starts at
    the first level. Clamped to the top level under the ceiling."""
    sat, e_obs, e_pred = np.float64(sat), np.float64(e_obs), np.float64(e_pred)
    d_pred = sat if e_obs >= 0.75 * e_pred else sat * (e_pred / e_obs)
    mult = max((2.0 * d_pred + 6.0) / base, 1.0)
    due = base * (1 << int(np.ceil(np.log2(mult))))
    top = base << max(0, int(np.floor(np.log2(ceiling / base))))
    return int(min(due, top))


def align_pair(h, v, pos_h: int, pos_v: int, rc: bool, overlap_est: int,
               cfg: dict):
    """One pair through the configured aligner. Returns (score, beg_h,
    end_h, beg_v, end_v, ended): `ended` is the static band whose
    extension ended the pair's route, or ADAPTIVE where the adaptive band
    did (the tail, or the adaptive backend)."""
    k, xdrop = cfg["kmer_size"], cfg["xdrop"]
    if cfg["aligner_backend"] not in ("auto", "pallas"):
        res = extend_pair(h, v, pos_h, pos_v, rc, k, xdrop,
                          int(cfg["band_width"]), True)
        return res[:5] + (ADAPTIVE,)
    W0 = static_band(cfg["pallas_band"])
    best = list(extend_pair(h, v, pos_h, pos_v, rc, k, xdrop, W0, False))
    if best[5] < W0 // 2 - 2 or not cfg["band_rescue"]:
        return tuple(best[:5]) + (W0,)
    ceiling = max(int(cfg["rescue_ceiling"]), 2 * W0)
    band = 2 * W0
    due = band
    if cfg["rescue_predict"]:
        e_obs = max(best[2] - best[1], best[4] - best[3], 1)
        e_pred = max(overlap_est, e_obs)
        due = predict_due(best[5], e_obs, e_pred, band, ceiling)
    pending = True
    ended = W0
    while pending and band <= ceiling:
        if due <= band:
            ended = band
            res = extend_pair(h, v, pos_h, pos_v, rc, k, xdrop, band, False)
            if res[0] >= best[0]:
                best = list(res)
            if res[5] >= band // 2 - 2:
                due = 2 * band
            else:
                pending = False
        band *= 2
    if pending:
        res = extend_pair(h, v, pos_h, pos_v, rc, k, xdrop,
                          int(cfg["band_width"]), True)
        if res[0] >= best[0]:
            best[:5] = res[:5]
        ended = ADAPTIVE
    return tuple(best[:5]) + (ended,)


def _work(job):
    return align_pair(*job)


def align_pairs(codes, offsets, pairs, cfg: dict,
                workers: int = 1) -> np.ndarray:
    """(P, 6) int64 score, beg_h, end_h, beg_v, end_v and the band the
    route ended at (align_pair's `ended`) of `pairs` (a detect.Pairs), on
    `workers` spawned processes (1: in this one)."""
    jobs = []
    for i in range(len(pairs)):
        hr, vr = int(pairs.read_h[i]), int(pairs.read_v[i])
        jobs.append((codes[offsets[hr]:offsets[hr + 1]],
                     codes[offsets[vr]:offsets[vr + 1]],
                     int(pairs.pos_h[i]), int(pairs.pos_v[i]),
                     bool(pairs.seed_rc[i]), int(pairs.overlap_est[i]),
                     cfg))
    # longest first, so the pool's last tasks are short
    order = sorted(range(len(jobs)),
                   key=lambda i: -(len(jobs[i][0]) + len(jobs[i][1])))
    if workers <= 1 or len(jobs) <= 1:
        got = [_work(jobs[i]) for i in order]
    else:
        import multiprocessing

        ctx = multiprocessing.get_context("spawn")
        with ctx.Pool(min(workers, len(jobs))) as pool:
            got = pool.map(_work, [jobs[i] for i in order], chunksize=1)
            pool.close()
            pool.join()  # every worker has ended before the run goes on
    out = np.zeros((len(jobs), 6), np.int64)
    for i, r in zip(order, got):
        out[i] = r
    return out
