"""Candidate-pair generation (counterpart of ``bella_tpu/overlap/pairs.py``):
every single-device branch of ``detect_overlaps``, plain or HOPC k-mers at
any k <= 32, and ``generate_candidates`` over reliable triples.

Reliable k-mers occur at most upper_freq times, so the A @ A^T SpGEMM
with the positional semiring is:

  1. COUNT - extract canonical k-mers, sort by (k-mer, strand), count each
             k-mer's occurrences, keep the reliable ones (lower <= count <=
             upper) and rank rows within their k-mer,
  2. EMIT  - for lag d = 1, 2, ..., pair row i with row i-d of the same
             k-mer (rows compacted by descending count, so lag d only
             reads the prefix of k-mers with more than d occurrences, and
             the loop ends at the largest count),
  3. CHAIN - sort the candidate rows by (pair, bin, pos_h, [flip,] pos_v),
             vote per pair for the best-supported overlap bin, and emit
             its first row as the pair's seed.

A candidate row is (h, v, bin, pos_h, pos_v, flip) as int32 tensors; the
chain sort packs whatever bits the corpus needs into int64 words
(``_lex_order``). The JAX package's branches differ in how rows pack
into uint32 sort operands, which only sets the data widths they hold:

  * packed (at most 65,535 reads and bases a read, upper_freq <= 255,
    bin_size >= 3) and wide-id (``_sort_kmers_wide`` ..
    ``_chain_scans_wide``: reads numbered beyond 16 bits) order rows with
    flip below pos_h and saturate count (16 bits) and matches (13 bits);
    here they are one code path;
  * unpacked (``_fused_emit``, ``_chain_stage32``, ``_compact``: reads
    over 65,535 bp, upper_freq > 2^15 or bin_size < 3, and
    ``_emit_and_chain`` over triples) orders rows by (pos_h, pos_v)
    without the flip bit and saturates nothing (``unpacked=True``).

Beyond the single-pass budget, the memory ladder of the JAX package runs
(``detection_rung``): the fused split-count path (passes over hash
partitions of k-mer space, re-extracting read chunks once per group of
passes), the hv-range staged chain, then host-staged reliable triples fed
to ``generate_candidates``. Within the single pass, candidate rows beyond
the chain's share of the budget (k-mers of many copies: HiFi reads at
depth) are chained one range of H reads at a time, as the staged chain
does. The single pass, the split path and the staged chain give the same
pairs; the triples rung and generate_candidates' unpacked branch seed by
the unpacked rule. So the two gates that switch a
short-read corpus to that rule (the staged chain's and generate_candidates'
packed one) keep the JAX package's bytes, and the rest are set from peaks
measured on the card. The TPU
workarounds of those paths are not ported: fixed-width accumulator
windows (``_accum_append``) become lists of per-pass row blocks joined by
``torch.cat``, pass tags packed into key bits (``_part_shift``,
``_part_packable``) a stable sort by pass, and the 2-bit chunk uploads,
size buckets, speculative size hints and compile-ahead calls have no
counterpart.

Each stage opens a span (``utils/log.span``) on every path that runs it:
``bella.detect.extract``, ``bella.detect.count`` (the sort, count and
compaction), ``bella.detect.emit`` (with an h-range chain's count of rows
by read) and ``bella.detect.chain``; ``detect.rows`` counts
the candidate rows emitted and ``detect.ranges`` the chains run.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from bella_tpu_torch.seq.encode import (
    SENTINEL, canonical_from_window, canonical_kmers, hash64, hash_mod,
    hopc_kmers, pack_kmers, uorder,
)
from bella_tpu_torch.utils import segments as seg
from bella_tpu_torch.utils.log import count, log, span

# Device bytes of the memory ladder. The gates that change no output sit
# above the peak torch.cuda.max_memory_allocated gave on an H100 (the
# ladder phase of chip_smoke.py; PERF.md §5 lists the peaks); the two that
# choose the seed rule are the JAX package's, and the rungs they admit are
# sized to fit them.
SINGLE_PASS_BYTES = 110  # per k-mer position: the single pass (peak 97.5)
SPLIT_BYTES = 20         # per base: the fused split path (peak 14.2-15.7)
STAGED_BYTES = 4         # per base: the hv-range staged chain (JAX's)
TRIPLE_BYTES = 100       # per triple: generate_candidates' packed rule (JAX's)
ROW_BYTES = 25           # per expanded row: its unpacked one stage (22.3)
PASS_BYTES = 200         # per base: sets the split passes, so that a
                         # pass's count takes about half the budget
CHUNK_BYTES = 240        # per base of a read chunk the split path extracts
ACC_BYTES = 16           # per k-mer row a pass holds between chunks
CAND_BYTES = 120         # per candidate row of a chained h-range
CHAIN_SHARE = 0.5        # of the budget: a chained h-range's rows

_U16 = 0xFFFF
_I31 = (1 << 31) - 1


@dataclasses.dataclass
class CandidatePairs:
    """One row per candidate read pair (H = larger read id, V = smaller),
    the fields of bella_tpu.overlap.pairs.CandidatePairs."""

    read_h: np.ndarray    # (P,) int32
    read_v: np.ndarray    # (P,) int32
    pos_h: np.ndarray     # (P,) int32 seed k-mer start on H (raw coords)
    pos_v: np.ndarray     # (P,) int32 seed k-mer start on V
    count: np.ndarray     # (P,) int32 total shared k-mer occurrences
    matches: np.ndarray   # (P,) int32 support of the winning bin
    overlap_est: np.ndarray  # (P,) int32 overlap estimate of the seed
    seed_rc: np.ndarray   # (P,) bool  seed strands disagree -> 'c' strand

    @property
    def num_pairs(self) -> int:
        return int(self.read_h.shape[0])

    @staticmethod
    def empty() -> "CandidatePairs":
        z = np.zeros(0, np.int32)
        return CandidatePairs(z, z, z, z, z, z, z, np.zeros(0, bool))

    @staticmethod
    def concatenate(parts) -> "CandidatePairs":
        parts = [p for p in parts if p.num_pairs]
        if not parts:
            return CandidatePairs.empty()
        return CandidatePairs(*(
            np.concatenate([getattr(p, f.name) for p in parts])
            for f in dataclasses.fields(CandidatePairs)
        ))


def window_kmers(k: int, hopc: bool) -> bool:
    """Whether detection takes the windowed extractor (plain k <= 28) or
    the per-position one (HOPC, k = 29..32)."""
    return not hopc and k <= 28


def detection_rung(reads, config) -> str:
    """The branch detect_overlaps takes: "packed", "wide" or "unpacked"
    (one pass), or beyond the single-pass budget "split" (fused
    split-count path), "staged" (hv-range staged chain) or "triples"
    (host-staged reliable triples and generate_candidates). HOPC and
    k > 28 go from the single pass straight to "triples", as in the JAX
    package."""
    k = config.kmer_size
    total = len(reads.codes)
    R = reads.num_reads
    max_len = int(reads.lengths.max()) if R else 0
    budget = config.effective_memory_mb * 1e6
    short = max_len <= _U16 and config.bin_size >= 3
    if (total - k + 1) * SINGLE_PASS_BYTES > budget:
        if (short and window_kmers(k, config.use_hopc) and R < _I31
                and config.upper_freq <= 1 << 15):
            if total * SPLIT_BYTES <= budget:
                return "split"
            if total * STAGED_BYTES <= budget:
                return "staged"
        return "triples"
    if short and R <= _U16 and config.upper_freq <= 255:
        return "packed"
    if short and R < _I31 and config.upper_freq <= 1 << 15:
        return "wide"
    return "unpacked"


# ----------------------------------------------------------------------
# COUNT
# ----------------------------------------------------------------------


def _extract_kmers(codes, lengths, offsets, k: int, rid_base: int = 0,
                   hopc: bool = False):
    """Per-position k-mer stream: sort keys and payloads read << 32 |
    position (read ids offset by rid_base).

    The keys are int64s canonical << 1 | strand (SENTINEL where the
    k-mer crosses a read end) while the canonical k-mer fits 62 bits
    (k <= 31). At k = 32 that key takes 65 bits, so the keys are a pair
    (uorder(canonical) or SENTINEL, strand) that _sort_stream orders the
    same way. Plain k <= 28 packs windows first base lowest
    (canonical_from_window); HOPC and k > 28 take bella_tpu's
    per-position extractor (pack_kmers and canonical_kmers, or
    hopc_kmers)."""
    with span("detect.extract"):
        dev = codes.device
        n = codes.numel()
        m = n - k + 1
        if window_kmers(k, hopc):
            c = codes.to(torch.int64)
            raw = torch.zeros(m, dtype=torch.int64, device=dev)
            for t in range(k):  # first base in the lowest 2-bit group
                raw |= c[t:t + m] << (2 * t)
            del c
            canon, is_rc = canonical_from_window(raw, k)
            del raw
        elif hopc:
            canon, _, is_rc = hopc_kmers(codes, k)
        else:
            canon, is_rc = canonical_kmers(pack_kmers(codes, k), k)
        R = lengths.numel()
        rid = torch.repeat_interleave(
            torch.arange(R, device=dev, dtype=torch.int64), lengths,
            output_size=n)[:m]
        pos = torch.arange(m, device=dev, dtype=torch.int64) - offsets[rid]
        valid = pos + k <= lengths[rid]
        payload = ((rid + rid_base) << 32) | pos
        if k == 32:
            return (torch.where(valid, uorder(canon), SENTINEL),
                    is_rc & valid), payload
        key = torch.where(valid, (canon << 1) | is_rc.to(torch.int64),
                          SENTINEL)
        return key, payload


def _sort_stream(key, payload):
    """Sort the k-mer stream by (k-mer, strand). Returns (the sorted
    payloads; the sorted k-mer bits, whose runs are the segments; the
    sorted strands; the dead rows, whose key is SENTINEL). A k = 32 pair
    of keys sorts in two stable passes, strand first: the order of the
    one-word key."""
    if isinstance(key, tuple):
        kmer, strand = key
        perm = torch.sort(strand.to(torch.uint8), stable=True)[1]
        perm = perm[torch.sort(kmer[perm], stable=True)[1]]
        skmer = kmer[perm]
        return (payload[perm], skmer, strand[perm].to(torch.int64),
                skmer == SENTINEL)
    skey, perm = torch.sort(key)
    payload = payload[perm]
    del perm
    return payload, skey >> 1, skey & 1, skey == SENTINEL


def _count_sorted(key, payload, lower: int, upper: int):
    """Sort by (k-mer, strand) and count (counterpart of _sort_kmers,
    _count_sorted and their wide twins). Segments are runs of equal k-mer
    bits (the strand bit is below them). Returns the sorted payloads,
    strand bits, within-k-mer ranks, counts, the reliable mask, nnzs
    (nnzs[d] = reliable rows of k-mers with count > d, d < upper) and the
    number of reliable k-mers."""
    with span("detect.count"):
        payload, skmer, sc, sentinel = _sort_stream(key, payload)
        kb = seg.boundaries(skmer)
        del skmer
        ones = torch.ones_like(sc)
        cnt = seg.seg_sum_bcast(ones, kb)
        rank = seg.seg_cumsum(ones, kb) - 1
        reliable = (cnt >= lower) & (cnt <= upper) & ~sentinel
        nnzs = _lag_sizes(cnt[reliable], upper)
        num_kmers = int((kb & reliable).sum())
        return payload, sc, rank, cnt, reliable, nnzs, num_kmers


def _lag_sizes(cnt, upper: int) -> np.ndarray:
    """nnzs[d] = rows whose k-mer has more than d rows, d = 0 .. upper-1,
    from the rows' counts: the prefix that lag d reads in the
    count-descending order."""
    hist = torch.bincount(cnt, minlength=upper + 1)
    above = hist.flip(0).cumsum(0).flip(0)  # above[c] = rows with count >= c
    return above[1:upper + 1].cpu().numpy().astype(np.int64)


def _compact(payload, sc, rank, cnt, reliable):
    """Reliable rows ordered by DESCENDING count, ties in stream order
    (counterpart of _compact_sort / _compact_slice and their wide twins):
    whole k-mers stay contiguous and in order, and the rows usable at lag
    d (count > d) form a prefix. Returns (read, position, strand, rank),
    int32 but the strand."""
    with span("detect.count"):
        rows = torch.nonzero(reliable).squeeze(1)
        rows = rows[torch.sort(-cnt[rows], stable=True)[1]]
        p = payload[rows]
        i32 = torch.int32
        return ((p >> 32).to(i32), (p & 0xFFFFFFFF).to(i32), sc[rows],
                rank[rows].to(i32))


def _rank_from_ids(kmer_ids):
    """Within-segment rank and segment count of a k-mer-id-major triple
    stream."""
    kb = seg.boundaries(kmer_ids)
    ones = torch.ones_like(kmer_ids, dtype=torch.int64)
    return seg.seg_cumsum(ones, kb) - 1, seg.seg_sum_bcast(ones, kb)


# ----------------------------------------------------------------------
# EMIT
# ----------------------------------------------------------------------


def _lags(sr, rank, nnzs):
    """(d, size, ok) for every lag d: row i of [d, size) pairs with row
    i - d where ok (one k-mer, two reads)."""
    for d in range(1, len(nnzs)):
        size = int(nnzs[d])  # rows of count > d
        if size <= d:
            break  # counts only fall along the prefix
        yield d, size, (rank[d:size] >= d) & (sr[d:size] != sr[:size - d])


def candidate_rows(nnzs) -> int:
    """The candidate rows that every lag emits, from nnzs alone, with the
    pairs of two rows in one read that _emit drops: a k-mer of c rows
    gives C(c, 2), and nnzs[1:] counts each of its rows c - 1 times, so
    the rows are half of its sum."""
    return int(np.sum(nnzs[1:])) // 2


def _emit(sr, sp, sc, rank, nnzs, lens, k: int, bin_size: int,
          h_range=None):
    """Candidate rows of every lag, live rows only, as a tuple of int32
    tensors (h, v, bin, pos_h, pos_v) and a bool flip (counterpart of
    _fused_emit_packed, _fused_emit_wide, _fused_emit and _emit_slices +
    _multiop). h_range = (lo, hi) keeps only pairs with lo <= h < hi (the
    chain by h-ranges). The overlap estimate is at least k, so its bin
    needs no clamp. Counts the rows it returns as detect.rows."""
    with span("detect.emit"):
        hs, vs, bins, phs, pvs, fls = [], [], [], [], [], []
        for d, size, ok in _lags(sr, rank, nnzs):
            ra, rb = sr[d:size], sr[:size - d]
            h = torch.maximum(ra, rb)
            if h_range is not None:
                ok &= (h >= h_range[0]) & (h < h_range[1])
            ra, rb, h = ra[ok], rb[ok], h[ok]
            pa, pb = sp[d:size][ok], sp[:size - d][ok]
            flip = sc[d:size][ok] != sc[:size - d][ok]
            h_is_a = ra > rb
            v = torch.minimum(ra, rb)
            pos_h = torch.where(h_is_a, pa, pb)
            pos_v = torch.where(h_is_a, pb, pa)
            len_h, len_v = lens[h], lens[v]
            beg_h = torch.where(flip, len_h - pos_h - k, pos_h)
            ov = (torch.minimum(beg_h, pos_v)
                  + torch.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
                  + k)
            for out, a in ((hs, h), (vs, v), (bins, ov // bin_size),
                           (phs, pos_h), (pvs, pos_v)):
                out.append(a.to(torch.int32))
            fls.append(flip)
        if hs:
            rows = tuple(torch.cat(x) for x in (hs, vs, bins, phs, pvs, fls))
        else:
            z = torch.zeros(0, dtype=torch.int32, device=sr.device)
            rows = (z, z, z, z, z,
                    torch.zeros(0, dtype=torch.bool, device=sr.device))
    count("detect.rows", rows[0].numel())
    return rows


def _emit_ordered(kmer_ids, read_ids, positions, is_rc, upper: int):
    """Triples (kmer-id-major) in the count-descending order _emit reads,
    with their ranks and lag sizes."""
    rank, cnt = _rank_from_ids(kmer_ids)
    nnzs = _lag_sizes(cnt, max(upper, int(cnt.max())))
    order = torch.sort(-cnt, stable=True)[1]
    del cnt
    i32 = torch.int32
    return (read_ids[order].to(i32), positions[order].to(i32), is_rc[order],
            rank[order].to(i32), nnzs)


def _cat_rows(parts):
    if len(parts) == 1:  # one part needs no copy
        return tuple(parts[0])
    return tuple(torch.cat([p[i] for p in parts]) for i in range(6))


# ----------------------------------------------------------------------
# CHAIN
# ----------------------------------------------------------------------


def _lex_order(fields) -> torch.Tensor:
    """Permutation sorting rows by `fields` (most significant first), each
    a nonnegative integer tensor: fields pack, from the least significant
    up, into as few 63-bit int64 words as hold them (no field is split),
    and one stable sort per word runs from the least significant word."""
    words, cur, used = [], None, 0
    for t in reversed(fields):
        t = t.to(torch.int64)
        nb = max(int(t.max()).bit_length(), 1)
        if cur is not None and used + nb > 63:
            words.append(cur)
            cur, used = None, 0
        cur = t if cur is None else cur | (t << used)
        used += nb
    words.append(cur)
    perm = None
    for w in words:
        o = torch.sort(w if perm is None else w[perm], stable=True)[1]
        perm = o if perm is None else perm[o]
    return perm


def _chain(rows, k: int, unpacked: bool):
    """Chain the candidate rows (counterpart of the chain sorts
    _chain_sort_packed / _chain_sort_wide / _chain_stage32 and the scans
    _chain_scans_packed / _chain_scans_wide / _chain_sorted): sort by the
    full key, so the seed does not depend on the emit order; support of a
    bin counts distinct pos_h // (k+1) buckets, count is the pair's rows;
    the bin with the highest support (then the lowest bin) wins and its
    first row is the seed. Returns the seed rows' (h, v, count, support,
    pos_h, pos_v, flip), sorted by (h, v). Counts one chain as
    detect.ranges."""
    count("detect.ranges")
    with span("detect.chain"):
        h, v, bin_, pos_h, pos_v, flip = rows
        key = [h, v, bin_, pos_h] + ([] if unpacked else [flip]) + [pos_v]
        perm = _lex_order(key)
        h, v, bin_, pos_h, pos_v, flip = (a[perm] for a in rows)
        pair_b = seg.boundaries((h.to(torch.int64) << 31) | v)
        bin_b = pair_b | seg.boundaries(bin_)
        bucket = pos_h // (k + 1)
        prev_bucket = torch.cat([bucket[:1], bucket[:-1]])
        kept = bin_b | (bucket != prev_bucket)
        support = seg.seg_sum_bcast(kept, bin_b)
        rows_in_pair = seg.seg_sum_bcast(torch.ones_like(pos_h), pair_b)
        binidx = seg.seg_cumsum(bin_b, pair_b)  # 1-based bin rank in a pair
        score = (support << 32) - binidx
        best = seg.seg_max_bcast(score, pair_b)
        s = torch.nonzero((score == best) & bin_b).squeeze(1)
        return (h[s], v[s], rows_in_pair[s], support[s], pos_h[s], pos_v[s],
                flip[s])


def _unpack_pairs(h, v, count, support, pos_h, pos_v, flip, lengths_np,
                  k: int, unpacked: bool) -> CandidatePairs:
    """Host half: the packed and wide branches saturate count to 16 bits
    and matches to 13 bits (the unpacked branch does not); the overlap
    estimate is recomputed with the int32 formula (chain.hpp:48-71)."""
    count = count.cpu().numpy()
    matches = support.cpu().numpy()
    if not unpacked:
        count = np.minimum(count, _U16)
        matches = np.minimum(matches, 0x1FFF)
    read_h = h.cpu().numpy().astype(np.int32)
    read_v = v.cpu().numpy().astype(np.int32)
    pos_h = pos_h.cpu().numpy().astype(np.int32)
    pos_v = pos_v.cpu().numpy().astype(np.int32)
    flip = flip.cpu().numpy().astype(bool)
    lens = np.asarray(lengths_np, dtype=np.int32)
    k = np.int32(k)
    len_h = lens[read_h]
    len_v = lens[read_v]
    beg_h = np.where(flip, len_h - pos_h - k, pos_h)
    ov = (
        np.minimum(beg_h, pos_v)
        + np.minimum(len_h - (beg_h + k), len_v - (pos_v + k))
        + k
    ).astype(np.int32)
    return CandidatePairs(read_h, read_v, pos_h, pos_v,
                          count.astype(np.int32), matches.astype(np.int32),
                          ov, flip)


def _chain_pairs(rows, lengths_np, k: int, unpacked: bool) -> CandidatePairs:
    if rows[0].numel() == 0:
        return CandidatePairs.empty()
    return _unpack_pairs(*_chain(rows, k, unpacked), lengths_np, k, unpacked)


def _on(comp, dev):
    """Compacted rows on the device (uploaded when held on the host)."""
    return tuple(torch.from_numpy(a).to(dev) if isinstance(a, np.ndarray)
                 else a for a in comp)


def _rows_by_h(parts, R: int, dev) -> np.ndarray:
    """The cumulative sum over reads of each read's candidate rows as h:
    one sweep of every part's lags."""
    with span("detect.emit"):
        per_h = torch.zeros(R, dtype=torch.int64, device=dev)
        for comp, nnzs in parts:
            sr, rank = _on((comp[0], comp[3]), dev)
            for d, size, ok in _lags(sr, rank, nnzs):
                h = torch.maximum(sr[d:size], sr[:size - d])[ok]
                per_h += torch.bincount(h, minlength=R)
        return per_h.cumsum(0).cpu().numpy()


def _chain_by_h_ranges(parts, lengths_dev, lengths_np, k: int,
                       bin_size: int, unpacked: bool, chain_bytes: float):
    """Emit and chain the candidate rows of `parts` ((compacted rows,
    nnzs) each, on the device or the host) one read range of h at a time
    (the reference's column-block staging role, include/overlap.hpp:
    682-710). Where the rows that the counts give (candidate_rows) fit
    chain_bytes, one chain takes them all; else a first pass counts each
    read's rows as h, so a range holds at most chain_bytes / CAND_BYTES
    rows (or one read's). A pair's rows share h, so ranges partition
    pairs, and chaining is per pair: the result is one chain's. `parts`
    is emptied once the last range is emitted, so a caller that holds no
    other reference frees its compacted rows before the last chain."""
    dev = lengths_dev.device
    R = len(lengths_np)
    if sum(candidate_rows(nnzs) for _, nnzs in parts) * CAND_BYTES \
            <= chain_bytes:
        bounds, cum = [0, R], None
    else:
        cum = _rows_by_h(parts, R, dev)
        cap = max(int(chain_bytes // CAND_BYTES), 1)
        bounds = [0]
        while bounds[-1] < R:
            lo = bounds[-1]
            base = int(cum[lo - 1]) if lo else 0
            hi = int(np.searchsorted(cum, base + cap, side="right"))
            bounds.append(max(hi, lo + 1))
        log("chainRanges", f"{len(bounds) - 1} h-ranges x {len(parts)} "
            f"passes ({int(cum[-1])} rows, at most {cap} a range)")
    out = []
    for lo, hi in zip(bounds, bounds[1:]):
        if cum is not None and cum[hi - 1] == (cum[lo - 1] if lo else 0):
            continue
        h_range = None if hi - lo == R else (lo, hi)
        rows = _cat_rows([_emit(*_on(comp, dev), nnzs, lengths_dev, k,
                                bin_size, h_range) for comp, nnzs in parts])
        if hi == R:
            parts.clear()
        out.append(_chain_pairs(rows, lengths_np, k, unpacked))
        del rows
    return out[0] if len(out) == 1 else CandidatePairs.concatenate(out)


# ----------------------------------------------------------------------
# detect_overlaps and the memory ladder
# ----------------------------------------------------------------------


def detect_overlaps(reads, config, device="cuda"):
    """End-to-end overlap detection on one device. Returns
    (CandidatePairs sorted by (read_h, read_v), num_kmers, nnz): the
    result of bella_tpu.overlap.pairs.detect_overlaps. The branch is
    detection_rung's. As there, minimizer and syncmer selection is
    run_pipeline's modular branch and is not applied here. The single
    pass chains its rows through _chain_by_h_ranges: in one chain where
    the rows that counting gives (candidate_rows) fit the chain's share of
    the budget, else one range of h at a time, with the same pairs."""
    from bella_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    k = config.kmer_size
    if len(reads.codes) - k + 1 <= 0:
        return CandidatePairs.empty(), 0, 0
    rung = detection_rung(reads, config)
    budget = config.effective_memory_mb * 1e6
    if rung in ("split", "staged"):
        return _detect_overlaps_split(reads, config, budget,
                                      staged_chain=rung == "staged",
                                      device=dev)
    if rung == "triples":
        from bella_tpu_torch.kmers.count import build_reliable_triples

        tri = build_reliable_triples(reads, config, device=dev)
        pairs = generate_candidates(tri, reads.lengths, config, device=dev)
        return pairs, tri.num_kmers, tri.nnz
    codes = torch.from_numpy(np.ascontiguousarray(reads.codes)).to(dev)
    lengths = torch.from_numpy(reads.lengths.astype(np.int64)).to(dev)
    offsets = torch.from_numpy(reads.offsets.astype(np.int64)).to(dev)
    key, payload = _extract_kmers(codes, lengths, offsets, k,
                                  hopc=config.use_hopc)
    del codes
    payload, sc, rank, cnt, reliable, nnzs, num_kmers = _count_sorted(
        key, payload, config.lower_freq, config.upper_freq
    )
    del key
    nnz = int(nnzs[0])
    if nnz == 0:
        return CandidatePairs.empty(), num_kmers, 0
    parts = [(_compact(payload, sc, rank, cnt, reliable), nnzs)]
    del payload, sc, rank, cnt, reliable
    return (_chain_by_h_ranges(parts, lengths, reads.lengths, k,
                               config.bin_size, rung == "unpacked",
                               budget * CHAIN_SHARE), num_kmers, nnz)


def _chunk_bounds(reads, cb: int):
    """Read-aligned chunks of at most cb bases (or one read)."""
    offsets = reads.offsets.astype(np.int64)
    bounds = [0]
    R = reads.num_reads
    while bounds[-1] < R:
        lo = bounds[-1]
        hi = int(np.searchsorted(offsets, offsets[lo] + cb, side="right")) - 1
        bounds.append(min(max(hi, lo + 1), R))
    return list(zip(bounds, bounds[1:]))


def _partition_chunk(reads, lo: int, hi: int, k: int, splits: int, dev):
    """One read chunk's k-mer rows sorted by pass (hash64(canonical) %
    splits, the reference's --split-count partition), and each pass's
    row range (counterpart of _chunk_partition)."""
    off = reads.offsets
    codes = torch.from_numpy(np.ascontiguousarray(
        reads.codes[int(off[lo]):int(off[hi])])).to(dev)
    lengths = torch.from_numpy(reads.lengths[lo:hi].astype(np.int64)).to(dev)
    offsets = torch.from_numpy(
        (off[lo:hi + 1] - off[lo]).astype(np.int64)).to(dev)
    if codes.numel() < k:
        e = torch.zeros(0, dtype=torch.int64, device=dev)
        return e, e, np.zeros(splits + 2, np.int64)
    key, payload = _extract_kmers(codes, lengths, offsets, k, rid_base=lo)
    del codes
    part = hash_mod(hash64(key >> 1), splits)
    part = torch.where(key == SENTINEL, splits, part)
    part, order = torch.sort(part, stable=True)
    starts = np.zeros(splits + 2, np.int64)
    np.cumsum(torch.bincount(part, minlength=splits + 1).cpu().numpy(),
              out=starts[1:])
    return key[order], payload[order], starts


def _detect_overlaps_split(reads, config, budget: float,
                           force_group: int = 0, staged_chain: bool = False,
                           device="cuda"):
    """Beyond the single-pass budget: k-mer-space split counting (the
    reference's --split-count, include/kmercount.hpp:478-534).

    1. reads are cut into chunks at read boundaries; each chunk's k-mers
       are extracted and partitioned by hash64(k-mer) % splits,
    2. passes run in groups that fit the budget: for each group every
       chunk is extracted again and its rows of the group's passes kept;
       then each pass is counted and compacted on its own,
    3. each pass emits its candidate rows (lag prefixes as the single
       pass), and one chain runs over them all; with staged_chain, the
       compacted rows of every pass go to host memory instead and
       _staged_chain_finish chains one read range at a time.

    Passes own disjoint k-mer sets, so segments stay whole and the pairs
    are the single pass's. Rows hold any read id, so the JAX package's
    `wide` switch has no counterpart. force_group sets the passes a group
    holds (0: as many as the budget allows)."""
    from bella_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    k = config.kmer_size
    total = len(reads.codes)
    max_len = int(reads.lengths.max()) if reads.num_reads else 0
    splits = max(-(-int(total * PASS_BYTES) // int(budget)), 2)
    chunks = _chunk_bounds(
        reads, max(min(int(budget / CHUNK_BYTES), total), max_len + 1))
    pass_rows = total // splits * 7 // 5 + 1  # hash imbalance slack
    group = force_group or max(1, min(
        splits, int(budget * 0.4) // (pass_rows * ACC_BYTES)))
    n_groups = -(-splits // group)
    log("splitPasses", f"{splits} passes in {n_groups} groups of {group}, "
        f"{len(chunks)} read chunks")
    lengths_dev = torch.from_numpy(reads.lengths.astype(np.int64)).to(dev)
    kept = []  # per pass: emitted rows, or (staged) compacted rows + nnzs
    num_kmers = 0
    nnz_total = 0
    for g0 in range(0, splits, group):
        g1 = min(g0 + group, splits)
        acc = [[] for _ in range(g0, g1)]
        for lo, hi in chunks:
            key, payload, starts = _partition_chunk(reads, lo, hi, k,
                                                    splits, dev)
            for i, p in enumerate(range(g0, g1)):
                s, e = int(starts[p]), int(starts[p + 1])
                if e > s:
                    acc[i].append((key[s:e].clone(), payload[s:e].clone()))
            del key, payload
        for i in range(g1 - g0):
            if not acc[i]:
                continue
            key = torch.cat([a[0] for a in acc[i]])
            payload = torch.cat([a[1] for a in acc[i]])
            acc[i] = None
            payload, sc, rank, cnt, reliable, nnzs, nk = _count_sorted(
                key, payload, config.lower_freq, config.upper_freq)
            del key
            num_kmers += nk
            nnz_total += int(nnzs[0])
            if nnzs[0] == 0:
                continue
            comp = _compact(payload, sc, rank, cnt, reliable)
            del payload, sc, rank, cnt, reliable
            if staged_chain:
                kept.append((tuple(_to_host(a) for a in comp), nnzs))
            else:
                kept.append(_emit(*comp, nnzs, lengths_dev, k,
                                  config.bin_size))
            del comp
    if staged_chain:
        return _staged_chain_finish(kept, reads, config, budget, lengths_dev,
                                    num_kmers, nnz_total)
    if not kept:
        return CandidatePairs.empty(), num_kmers, nnz_total
    rows = _cat_rows(kept)
    del kept
    return (_chain_pairs(rows, reads.lengths, k, False), num_kmers,
            nnz_total)


def _staged_chain_finish(compact_parts, reads, config, budget: float,
                         lengths_dev, num_kmers: int, nnz_total: int):
    """hv-range staged emission and chaining: the passes' compacted
    reliable rows wait in host memory, and each h-range uploads them again
    (_chain_by_h_ranges), so the card holds one range's rows: the result
    is the fused path's."""
    if not compact_parts:
        return CandidatePairs.empty(), num_kmers, nnz_total
    return (_chain_by_h_ranges(compact_parts, lengths_dev, reads.lengths,
                               config.kmer_size, config.bin_size, False,
                               budget * CHAIN_SHARE), num_kmers, nnz_total)


# ----------------------------------------------------------------------
# generate_candidates over reliable triples
# ----------------------------------------------------------------------


def _emit_and_chain(kmer_ids, read_ids, positions, is_rc, lens, lengths_np,
                    upper: int, k: int, bin_size: int,
                    unpacked: bool) -> CandidatePairs:
    """Emission over a triple stream and the chain, in one stage."""
    sr, sp, sc, rank, nnzs = _emit_ordered(kmer_ids, read_ids, positions,
                                           is_rc, upper)
    rows = _emit(sr, sp, sc, rank, nnzs, lens, k, bin_size)
    return _chain_pairs(rows, lengths_np, k, unpacked)


def packed_rows(nnz: int, read_lengths, config) -> bool:
    """Whether generate_candidates takes the packed / wide rule (reads of
    at most 65,535 bp, bin_size >= 3, upper_freq <= 2^15, the triples
    within the budget) rather than the unpacked one."""
    n_reads = len(read_lengths)
    max_len = int(np.max(read_lengths)) if n_reads else 0
    return (n_reads < _I31 and max_len <= _U16 and config.bin_size >= 3
            and config.upper_freq <= 1 << 15
            and nnz * TRIPLE_BYTES <= config.effective_memory_mb * 1e6)


def generate_candidates(triples, read_lengths, config,
                        device="cuda") -> CandidatePairs:
    """Pairs from prebuilt reliable triples (the split-count path and the
    last rung of the memory ladder): the packed / wide emit and chain when
    reads fit 16-bit positions and the triples fit the budget (chained by
    h-ranges within it), else the unpacked one, in one stage or, beyond
    the budget, in k-mer-range stages spilled to host memory."""
    from bella_tpu_torch.config import resolve_device

    dev = resolve_device(device)
    if triples.nnz == 0:
        return CandidatePairs.empty()
    read_lengths = np.asarray(read_lengths)
    lens = torch.from_numpy(read_lengths.astype(np.int64)).to(dev)
    budget = config.effective_memory_mb * 1e6
    upper = config.upper_freq
    tri = [torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        triples.kmer_ids, triples.read_ids, triples.positions, triples.is_rc)]
    if packed_rows(triples.nnz, read_lengths, config):
        *comp, nnzs = _emit_ordered(*tri, upper)
        del tri
        held = sum(a.numel() * a.element_size() for a in comp)
        return _chain_by_h_ranges(
            [(comp, nnzs)], lens, read_lengths, config.kmer_size,
            config.bin_size, False, budget * CHAIN_SHARE - held)
    budget_rows = int(budget / ROW_BYTES)
    if triples.nnz * (upper - 1) <= budget_rows:
        return _emit_and_chain(*tri, lens, read_lengths, upper,
                               config.kmer_size, config.bin_size, True)
    del tri
    return _generate_candidates_staged(triples, lens, read_lengths, config,
                                       budget_rows)


def _to_host(t: torch.Tensor) -> np.ndarray:
    """Copy to host memory (pinned when the tensor is on a card)."""
    if not t.is_cuda:
        return t.numpy()
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    out.copy_(t)
    return out.numpy()


def _generate_candidates_staged(triples, lens, lengths_np, config,
                                budget_rows: int) -> CandidatePairs:
    """K-mer-range emission stages -> host spill -> host sort by pair ->
    pair-aligned chain chunks (include/overlap.hpp:682-786 reshaped); the
    unpacked branch's rows."""
    dev = lens.device
    k = config.kmer_size
    upper = config.upper_freq
    stage_nnz = max(budget_rows // (upper - 1), 1 << 14)
    kid = triples.kmer_ids
    nnz = triples.nnz
    starts = [0]
    while starts[-1] + stage_nnz < nnz:
        cut = starts[-1] + stage_nnz
        # a stage does not split a k-mer (unless one k-mer is wider)
        first = int(np.searchsorted(kid, kid[cut], side="left"))
        starts.append(first if first > starts[-1] else cut)
    starts.append(nnz)
    log("RequiredStages", len(starts) - 1)
    spill = [[] for _ in range(6)]
    for lo, hi in zip(starts, starts[1:]):
        stage = [torch.from_numpy(np.ascontiguousarray(a[lo:hi])).to(dev)
                 for a in (kid, triples.read_ids, triples.positions,
                           triples.is_rc)]
        sr, sp, sc, rank, nnzs = _emit_ordered(*stage, upper)
        rows = _emit(sr, sp, sc, rank, nnzs, lens, k, config.bin_size)
        for i, a in enumerate(rows):
            spill[i].append(_to_host(a))
    host = [np.concatenate(s) for s in spill]
    pair = (host[0].astype(np.int64) << 32) | host[1].astype(np.int64)
    order = np.argsort(pair, kind="stable")
    pair = pair[order]
    host = [a[order] for a in host]
    total = len(pair)
    chunk_rows = max(budget_rows // 2, 1)
    parts = []
    lo = 0
    while lo < total:
        hi = min(lo + chunk_rows, total)
        if hi < total:  # a chunk does not split a pair
            hi = int(np.searchsorted(pair, pair[hi - 1], side="right"))
        rows = tuple(torch.from_numpy(a[lo:hi]).to(dev) for a in host)
        parts.append(_chain_pairs(rows, lengths_np, k, True))
        lo = hi
    return CandidatePairs.concatenate(parts)
