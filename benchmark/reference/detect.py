"""Plain reference of candidate-pair detection, for the pairs of a sample
of reads.

BELLA's detection (bioRxiv 10.1101/464420, section 2): the canonical
k-mers of every read are counted over the whole corpus; a k-mer is
reliable when its count lies in [lower, upper]. Every two occurrences of
a reliable k-mer in two different reads make one row of the read pair
(H = the larger read id, V = the smaller) with the positions of the two
occurrences and whether their strands differ. A pair's rows vote for an
overlap bin (the overlap the row's seed implies, over the bin width);
the bin whose rows cover the most distinct pos_h // (k + 1) buckets
wins, the lowest bin on a tie, and its first row in (pos_h, [flip,]
pos_v) order is the pair's seed. The pair's count is its rows.

bella_tpu's packed rule (reads of at most 65,535 bp) orders a bin's rows
with the strand flip between pos_h and pos_v and saturates the count to
16 bits and the support to 13; its unpacked rule (longer reads) orders
them without the flip and saturates nothing.

Counting runs in plain torch ops on the given device (the whole corpus'
k-mers are sorted once); the pairs of the sampled reads are chained in
numpy. Nothing here imports the program: the reads come from the
benchmark's own generator.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

U16 = 0xFFFF
MATCHES_MAX = 0x1FFF
FIELDS = ("read_h", "read_v", "pos_h", "pos_v", "count", "matches",
          "overlap_est", "seed_rc")


@dataclasses.dataclass
class Pairs:
    """One row per read pair, sorted by (read_h, read_v)."""

    read_h: np.ndarray
    read_v: np.ndarray
    pos_h: np.ndarray
    pos_v: np.ndarray
    count: np.ndarray
    matches: np.ndarray
    overlap_est: np.ndarray
    seed_rc: np.ndarray

    def __len__(self) -> int:
        return len(self.read_h)

    def table(self) -> np.ndarray:
        """(P, 8) int64: the fields in FIELDS order."""
        return np.stack([np.asarray(getattr(self, f)).astype(np.int64)
                         for f in FIELDS], axis=1)


def packed_rule(lengths: np.ndarray, bin_size: int, upper: int) -> bool:
    """bella_tpu's packed / wide seed rule (the flip in the order, the
    counts saturated), else the unpacked one."""
    return (int(lengths.max()) <= U16 and bin_size >= 3
            and upper <= 1 << 15)


def kmer_table(codes: np.ndarray, offsets: np.ndarray, k: int,
               device, key_bits: int = 64):
    """Every valid k-mer position of the corpus: (canonical key, read,
    position, strand), as torch tensors on `device`. A k-mer is
    canonical as the smaller of its code and its reverse complement's,
    first base most significant. key_bits = 32 keeps the low 32 bits of
    each code: the control's narrower k-mer words."""
    c = torch.from_numpy(np.ascontiguousarray(codes)).to(device).long()
    n = c.numel()
    m = n - k + 1
    fwd = torch.zeros(m, dtype=torch.int64, device=device)
    rev = torch.zeros(m, dtype=torch.int64, device=device)
    for t in range(k):
        b = c[t:t + m]
        fwd = (fwd << 2) | b
        rev |= (3 - b) << (2 * t)
    del c
    strand = rev < fwd
    key = torch.minimum(fwd, rev)
    del fwd, rev
    if key_bits < 64:
        key &= (1 << key_bits) - 1
    lens = torch.from_numpy(np.diff(offsets).astype(np.int64)).to(device)
    offs = torch.from_numpy(offsets[:-1].astype(np.int64)).to(device)
    read = torch.repeat_interleave(
        torch.arange(len(lens), device=device), lens, output_size=n)[:m]
    pos = torch.arange(m, device=device) - offs[read]
    ok = pos + k <= lens[read]
    return key[ok], read[ok], pos[ok], strand[ok]


def sample_rows(codes, offsets, sample: np.ndarray, k: int, lower: int,
                upper: int, device, key_bits: int = 64):
    """The rows (h, v, pos_h, pos_v, flip) of every read pair with a read
    in `sample` (a bool mask over reads), as numpy arrays."""
    key, read, pos, strand = kmer_table(codes, offsets, k, device, key_bits)
    skey, perm = torch.sort(key)
    del key
    _, inv, cnt = torch.unique_consecutive(skey, return_inverse=True,
                                           return_counts=True)
    del skey
    start = torch.cumsum(cnt, 0) - cnt
    seg = torch.empty_like(inv)
    seg[perm] = inv
    in_s = torch.from_numpy(sample).to(device)
    scnt = cnt[seg]
    mine = torch.nonzero(in_s[read] & (scnt >= lower)
                         & (scnt <= upper)).squeeze(1)
    out = [[] for _ in range(5)]
    for t in range(upper):
        o = mine[t < scnt[mine]]
        p = perm[start[seg[o]] + t]
        ra, rb = read[o], read[p]
        # a pair of occurrences with both reads sampled comes up from
        # both sides: keep it once, from its H side
        keep = (ra != rb) & ((ra > rb) | ~in_s[rb])
        o, p, ra, rb = o[keep], p[keep], ra[keep], rb[keep]
        a_is_h = ra > rb
        for lst, x in zip(out, (torch.maximum(ra, rb), torch.minimum(ra, rb),
                                torch.where(a_is_h, pos[o], pos[p]),
                                torch.where(a_is_h, pos[p], pos[o]),
                                strand[o] != strand[p])):
            lst.append(x.cpu().numpy())
    return tuple(np.concatenate(x) for x in out)


def chain(rows, lengths: np.ndarray, k: int, bin_size: int,
          packed: bool) -> Pairs:
    """Seed and count every pair of the rows (see the module's note)."""
    h, v, ph, pv, flip = (np.asarray(a) for a in rows)
    h, v, ph, pv = (a.astype(np.int64) for a in (h, v, ph, pv))
    flip = flip.astype(bool)
    if len(h) == 0:
        z = np.zeros(0, np.int64)
        return Pairs(z, z, z, z, z, z, z, np.zeros(0, bool))
    lens = lengths.astype(np.int64)
    ov = _overlap(ph, pv, flip, lens[h], lens[v], k)
    bins = ov // bin_size
    keys = [h, v, bins, ph] + ([flip.astype(np.int64)] if packed else []) \
        + [pv]
    order = np.lexsort(keys[::-1])
    h, v, bins, ph, pv, flip = (a[order] for a in (h, v, bins, ph, pv, flip))
    n = len(h)
    new_pair = np.ones(n, bool)
    new_pair[1:] = (h[1:] != h[:-1]) | (v[1:] != v[:-1])
    new_bin = new_pair.copy()
    new_bin[1:] |= bins[1:] != bins[:-1]
    bucket = ph // (k + 1)
    kept = new_bin.copy()
    kept[1:] |= bucket[1:] != bucket[:-1]
    bin_start = np.flatnonzero(new_bin)
    support = np.add.reduceat(kept.astype(np.int64), bin_start)
    pair_start = np.flatnonzero(new_pair)
    count = np.diff(np.append(pair_start, n))
    bin_pair = np.cumsum(new_pair)[bin_start] - 1  # pair of each bin
    # best bin of each pair: most support, then the first (lowest) bin
    order_b = np.lexsort((np.arange(len(bin_start)), -support, bin_pair))
    first = np.ones(len(order_b), bool)
    first[1:] = bin_pair[order_b][1:] != bin_pair[order_b][:-1]
    best = order_b[first]
    s = bin_start[best]
    matches = support[best]
    if packed:
        count = np.minimum(count, U16)
        matches = np.minimum(matches, MATCHES_MAX)
    return Pairs(h[s], v[s], ph[s], pv[s], count, matches,
                 _overlap(ph[s], pv[s], flip[s], lens[h[s]], lens[v[s]], k),
                 flip[s])


def _overlap(ph, pv, flip, len_h, len_v, k: int):
    """The overlap a seed implies (BELLA's chain.hpp estimate)."""
    beg_h = np.where(flip, len_h - ph - k, ph)
    return (np.minimum(beg_h, pv)
            + np.minimum(len_h - (beg_h + k), len_v - (pv + k)) + k)


def detect_sample(codes, offsets, sample: np.ndarray, cfg: dict, device,
                  key_bits: int = 64) -> Pairs:
    """Every candidate pair with a read in `sample`, seeded and counted."""
    lengths = np.diff(offsets)
    rows = sample_rows(codes, offsets, sample, cfg["kmer_size"],
                       cfg["lower_freq"], cfg["upper_freq"], device,
                       key_bits)
    return chain(rows, lengths, cfg["kmer_size"], cfg["bin_size"],
                 packed_rule(lengths, cfg["bin_size"], cfg["upper_freq"]))
