"""The comparison that decides `correct`: what the timed path produced,
against the plain reference under benchmark/reference/, which works it
out again from the generated reads alone.

From the seed, a sample of reads is drawn: some uniformly, and the H
reads of a few of the program's pairs at each level above the first
band (the level of an alignment is the band of the static cascade whose
edge its drift off the seed's diagonal stays under, or past the widest
band), so that the rare routes of the cascade and its tail are held
every run. From the reference's pairs of those reads a sample of pairs
is drawn in turn: some uniformly, and some more of each level above
the first. The reference works each sampled pair out again along its
own route, and the route it ended at is counted.
The numbers compared, each with its limit (all exact: the limit is 0):

  detect_pairs_differing   pairs with a sampled read that the program
                           and the reference do not both give with the
                           same count, support, seed, overlap estimate
                           and strand;
  align_pairs_differing    sampled pairs whose score, four extents or
                           strand differ from the reference's (or that
                           the program lacks);
  decide_pairs_differing   sampled pairs that pass on one side only;
  rows_differing           sampled passing pairs whose M4 row in the
                           rows file is not the reference's;
  rows_file_lines_differing  lines of the rows file, as written, that
                           differ from the reference's decision and rows
                           over every pair and alignment the program
                           gave: the decision and the writer checked on
                           the whole output, from the program's own
                           alignments.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import decide as D
from benchmark.reference import detect as R
from benchmark.reference import xdrop as X

LIMITS = {
    "detect_pairs_differing": 0,
    "align_pairs_differing": 0,
    "decide_pairs_differing": 0,
    "rows_differing": 0,
    "rows_file_lines_differing": 0,
}


def draw(seed: int, num_reads: int, sample_reads: int):
    """The check's read sample (a bool mask) and its generator, from the
    run's seed."""
    rng = np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32,
                                 0xC4EC])
    mask = np.zeros(num_reads, bool)
    mask[rng.choice(num_reads, min(sample_reads, num_reads),
                    replace=False)] = True
    return mask, rng


def _key(h, v):
    return np.asarray(h, np.int64) << 32 | np.asarray(v, np.int64)


def _index(keys: np.ndarray, want: np.ndarray) -> np.ndarray:
    """Position of each of `want` in sorted unique `keys`, -1 if absent."""
    if not len(keys):
        return np.full(len(want), -1)
    i = np.minimum(np.searchsorted(keys, want), len(keys) - 1)
    return np.where(keys[i] == want, i, -1)


def detect_differing(got: np.ndarray, mask: np.ndarray, ref) -> int:
    """Pairs with a read in `mask` that `got` (a (P, 8) table in
    detect.FIELDS order, sorted by (read_h, read_v)) and the reference's
    `ref` do not both hold with every field equal."""
    got = got[mask[got[:, 0]] | mask[got[:, 1]]]
    want = ref.table()
    gk = _key(got[:, 0], got[:, 1])
    j = _index(gk, _key(want[:, 0], want[:, 1]))
    same = (j >= 0) & np.all(got[np.maximum(j, 0)] == want, axis=1)
    return int(len(want) - same.sum() + len(gk) - (j >= 0).sum())


def verdict(compared) -> bool:
    """`correct` from the numbers compared, [(name, value, limit)]: each
    within its limit, and at least one compared."""
    return bool(compared) and all(v <= lim for _, v, lim in compared)


def bands(flags: dict) -> list:
    """The static cascade's bands: the first, doubled up to the rescue
    ceiling (as reference/xdrop.align_pair visits them)."""
    w = X.static_band(flags["pallas_band"])
    top = max(int(flags["rescue_ceiling"]), 2 * w)
    out = []
    while w <= top:
        out.append(w)
        w *= 2
    return out


def levels(flags: dict, drift: np.ndarray) -> np.ndarray:
    """The level of each alignment's drift: i for the i-th band, the
    first whose edge (half the band less 2) the drift stays under, and
    len(bands) past the widest."""
    edges = np.array([b // 2 - 2 for b in bands(flags)])
    return np.searchsorted(edges, np.asarray(drift), side="right")


def drift(lens, pairs, aln, k: int) -> np.ndarray:
    """The drift off the seed's diagonal, at either end, of the
    alignment `aln` ((P, 5) score, beg_h, end_h, beg_v, end_v) of each
    of `pairs` (H on its reverse complement when the seed's strands
    differ)."""
    pos_h, pos_v = (np.asarray(getattr(pairs, f), np.int64)
                    for f in ("pos_h", "pos_v"))
    lh = np.asarray(lens)[np.asarray(pairs.read_h)]
    seh = np.where(np.asarray(pairs.seed_rc), lh - pos_h - k, pos_h) + k
    sev = pos_v + k
    left = (seh - aln[:, 1]) - (sev - aln[:, 3])
    right = (aln[:, 2] - seh) - (aln[:, 4] - sev)
    return np.maximum(np.abs(left), np.abs(right))


def pick_pairs(ref, level, n: int, per_level: int, rng):
    """A sample of the reference's pairs, drawn by rng: n uniformly, and
    up to per_level more of each level above 0 (`level`, one a pair)."""
    pick = rng.choice(len(ref), min(n, len(ref)), replace=False)
    rest = np.ones(len(ref), bool)
    rest[pick] = False
    extra = []
    for lv in range(1, int(level.max(initial=0)) + 1):
        pool = np.flatnonzero(rest & (level == lv))
        extra.append(rng.choice(pool, min(per_level, len(pool)),
                                replace=False))
    pick = np.sort(np.concatenate([pick] + extra).astype(np.int64))
    return R.Pairs(*(getattr(ref, f)[pick] for f in R.FIELDS)), pick


def compare(corpus, flags: dict, seed: int, sample: dict, pairs, aln,
            rows_path: str, device, workers: int) -> tuple:
    """([(name, value, limit)], {what was compared: how many}) for the
    program's pairs (a CandidatePairs), alignment (an AlignmentResult)
    and rows file of one pass over `corpus`."""
    lens = corpus.lengths
    names = [n.encode() for n in corpus.names]
    per_level = sample["sample_pairs_per_level"]
    got = np.stack([np.asarray(a, np.int64) for a in (
        aln.score, aln.beg_h, aln.end_h, aln.beg_v, aln.end_v)], axis=1)
    mask, rng = draw(seed, corpus.num_reads, sample["sample_reads"])
    got_level = levels(flags, drift(lens, pairs, got, flags["kmer_size"]))
    for lv in range(1, int(got_level.max(initial=0)) + 1):
        at_lv = np.flatnonzero(got_level == lv)
        at_lv = rng.choice(at_lv, min(per_level, len(at_lv)), replace=False)
        mask[np.asarray(pairs.read_h)[at_lv]] = True
    ref = R.detect_sample(corpus.codes, corpus.offsets, mask, flags, device)

    detect_bad = detect_differing(
        np.stack([np.asarray(getattr(pairs, f)).astype(np.int64)
                  for f in R.FIELDS], axis=1), mask, ref)

    # alignment, decision and rows, on a sample of the reference's
    # pairs, drawn in part by the level of the program's alignment
    all_keys = _key(pairs.read_h, pairs.read_v)
    at = _index(all_keys, _key(ref.read_h, ref.read_v))
    level = np.where(at >= 0, got_level[np.maximum(at, 0)], 0)
    sub, pick = pick_pairs(ref, level, sample["sample_pairs"], per_level,
                           rng)
    ra = X.align_pairs(corpus.codes, corpus.offsets, sub, flags, workers)
    ended = ra[:, 5]
    ra = ra[:, :5]
    at = at[pick]
    pa = got[np.maximum(at, 0)]
    strand_ok = np.asarray(aln.strand_rc)[np.maximum(at, 0)] == sub.seed_rc
    align_bad = int(((at < 0) | np.any(pa != ra, axis=1) | ~strand_ok).sum())

    er, delta = flags["error_rate"], flags["delta_chernoff"]
    passed, ov = D.decide(*ra.T, lens[sub.read_h], lens[sub.read_v], er,
                          delta)
    wanted = {(names[v], names[h]): i for i, (h, v) in
              enumerate(zip(sub.read_h.tolist(), sub.read_v.tolist()))}
    with open(rows_path, "rb") as f:
        file_lines = f.read().splitlines(keepends=True)
    in_file = {}  # the file's rows of the sampled pairs
    for line in file_lines:
        k = tuple(line.split(b"\t", 2)[:2])
        if k in wanted:
            in_file[k] = in_file.get(k, b"") + line
    decide_bad = sum(bool(passed[i]) != (k in in_file)
                     for k, i in wanted.items())
    lines = D.m4_lines(corpus.names, lens, sub.read_h, sub.read_v,
                       sub.count, ra[:, 0], ov, sub.seed_rc, ra[:, 3],
                       ra[:, 4], ra[:, 1], ra[:, 2])
    rows_bad = sum(bool(passed[i]) and in_file.get(k) != lines[i]
                   for k, i in wanted.items())

    # the decision and the writer over the whole output
    p_all, ov_all = D.decide(aln.score, aln.beg_h, aln.end_h, aln.beg_v,
                             aln.end_v, lens[pairs.read_h],
                             lens[pairs.read_v], er, delta)
    idx = np.flatnonzero(p_all)
    ref_lines = D.m4_lines(corpus.names, lens, pairs.read_h[idx],
                           pairs.read_v[idx], pairs.count[idx],
                           aln.score[idx], ov_all[idx],
                           aln.strand_rc[idx], aln.beg_v[idx],
                           aln.end_v[idx], aln.beg_h[idx], aln.end_h[idx])
    file_bad = sum(a != b for a, b in zip(ref_lines, file_lines)) + abs(
        len(ref_lines) - len(file_lines))

    values = dict(detect_pairs_differing=detect_bad,
                  align_pairs_differing=align_bad,
                  decide_pairs_differing=decide_bad,
                  rows_differing=rows_bad,
                  rows_file_lines_differing=file_bad)
    level_names = [str(b) for b in bands(flags)] + ["past"]
    compared = dict(
        sampled_reads=int(mask.sum()), sampled_read_pairs=len(ref),
        sampled_pairs=len(sub), rows_in_file=len(file_lines),
        pairs_by_drift_level={n: int((level[pick] == i).sum())
                              for i, n in enumerate(level_names)},
        pairs_by_route_end={("adaptive" if e == X.ADAPTIVE else str(e)):
                            int((ended == e).sum())
                            for e in sorted(set(ended.tolist()))})
    return [(k, v, LIMITS[k]) for k, v in values.items()], compared
