"""Frozen copy of the port's read simulator (``random_genome``,
``sample_reads``, ``write_fastq`` of ``bella_tpu_torch/io/simulate.py``).

It imports nothing of the port, so a later change to the port's
simulator cannot change the benchmark's corpora: one seed gives the same
bytes as long as this file stands. ``sample_reads`` returns plain arrays
(``Corpus``) instead of the port's ``ReadSet``; ``write_fastq`` writes the
same bytes as the port's, joined from slices of one decoded buffer
instead of a decode and a format per read. ``sample_reads`` may also
take each read's length from a fixed list, so that every seed makes the
same amount of work.
"""

from __future__ import annotations

import dataclasses
from typing import List

import numpy as np

_COMP = np.array([3, 2, 1, 0], dtype=np.uint8)
BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


@dataclasses.dataclass
class Corpus:
    """Reads back to back: codes[offsets[r]:offsets[r + 1]] is read r, in
    2-bit codes A=0 C=1 G=2 T=3."""

    names: List[str]
    codes: np.ndarray    # (total,) uint8
    offsets: np.ndarray  # (num_reads + 1,) int64

    @property
    def num_reads(self) -> int:
        return len(self.offsets) - 1

    @property
    def lengths(self) -> np.ndarray:
        return np.diff(self.offsets)

    @property
    def bases(self) -> int:
        return int(self.offsets[-1])


def random_genome(length: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return rng.integers(0, 4, size=length, dtype=np.int64).astype(np.uint8)


def sample_reads(genome: np.ndarray, num_reads: int, mean_len: int = 5000,
                 min_len: int = 1000, error_rate: float = 0.15,
                 seed: int = 1, circular: bool = True,
                 lengths=None) -> Corpus:
    """Noisy reads: gamma(4) lengths of mean `mean_len`, at least
    `min_len`; a random start and strand each; errors split 1/3
    substitution, 1/3 insertion, 1/3 deletion (PacBio CLR-like). The
    draws are the port's, in the port's order. With `lengths`, read i
    is lengths[i] bases long before its errors (its gamma draw is still
    made, so where `lengths` holds the draws of `seed` the reads are the
    same)."""
    rng = np.random.default_rng(seed)
    G = len(genome)
    seqs: List[np.ndarray] = []
    names: List[str] = []
    for i in range(num_reads):
        L = int(np.clip(rng.gamma(4.0, mean_len / 4.0), min_len, G))
        if lengths is not None:
            L = int(lengths[i])
        start = int(rng.integers(0, G if circular else max(G - L, 1)))
        idx = ((start + np.arange(L)) % G if circular
               else np.arange(start, start + L))
        frag = genome[idx]
        if bool(rng.integers(0, 2)):
            frag = _COMP[frag[::-1]]
        noisy = _apply_errors(frag, error_rate, rng)
        names.append(f"sim/{i}/0_{len(noisy)}")
        seqs.append(noisy)
    offsets = np.zeros(num_reads + 1, dtype=np.int64)
    np.cumsum([len(s) for s in seqs], out=offsets[1:])
    cat = np.concatenate(seqs) if seqs else np.zeros(0, np.uint8)
    return Corpus(names, cat, offsets)


def _apply_errors(frag: np.ndarray, error_rate: float, rng) -> np.ndarray:
    if error_rate <= 0:
        return frag.copy()
    L = len(frag)
    r = rng.random(L)
    sub = r < error_rate / 3
    ins = (r >= error_rate / 3) & (r < 2 * error_rate / 3)
    dele = (r >= 2 * error_rate / 3) & (r < error_rate)
    base = frag.copy()
    # substitutions: add 1..3 mod 4 so the base always changes
    base[sub] = (base[sub] + rng.integers(1, 4, size=int(sub.sum()))) % 4
    # each input base emits 0 (deleted), 1 (kept) or 2 (an inserted
    # random base, then the base) output symbols
    emit = (1 - dele.astype(np.int64)) + ins.astype(np.int64)
    offsets = np.concatenate([[0], np.cumsum(emit)])
    out = np.zeros(int(offsets[-1]), dtype=np.uint8)
    kept = emit >= 1
    out[offsets[:-1][kept] + emit[kept] - 1] = base[kept]
    has_ins = emit == 2
    out[offsets[:-1][has_ins]] = rng.integers(0, 4, size=int(has_ins.sum()))
    return out


def fastq_bytes(corpus: Corpus, qual_char: str = "I") -> bytes:
    """The FASTQ text of the corpus, ``@name\\nSEQ\\n+\\nQUAL\\n`` a read,
    as the port's write_fastq writes it."""
    seq = BASES[corpus.codes].tobytes()
    lens = corpus.lengths
    qual = qual_char.encode() * (int(lens.max()) if len(lens) else 0)
    off = corpus.offsets
    parts = []
    for r, name in enumerate(corpus.names):
        s, e = int(off[r]), int(off[r + 1])
        parts += (b"@", name.encode(), b"\n", seq[s:e], b"\n+\n",
                  qual[:e - s], b"\n")
    return b"".join(parts)


def write_fastq(path: str, corpus: Corpus, qual_char: str = "I") -> None:
    with open(path, "wb") as f:
        f.write(fastq_bytes(corpus, qual_char))
