"""HiFi detection on the CPU against bella_tpu: the detection flags of
BELLA's HiFi setting (k 31, -e 0.005, k-mer counts in [19, 30] at depth
30, bin 500) on a seeded HiFi-like corpus, ~30X over a 20 kbp circular
genome, reads of ~13.5 kbp at 0.5 % error, so k-mers of up to 30 rows
emit over 29 lags.

bella_tpu.detect_overlaps gives the port's pairs, num_kmers and nnz field
for field, on the port's single chain and again with total_memory_mb
between the corpus' k-mer positions' bytes and its candidate rows' bytes,
where the single pass still holds but its rows are emitted and chained in
three or more h-ranges with the same detect.rows. A CLR corpus at BELLA's
defaults keeps one chain. candidate_rows, which routes, counts each
k-mer's pairs of rows. Under a profiler every path's stages open their
bella.detect.* spans, a chain span for each chain counted, and a single
pass whose rows fit makes no count of rows by read.
"""

import functools

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bella_tpu.io.simulate import random_genome, sample_reads
from bella_tpu_torch.config import BellaConfig
from bella_tpu_torch.overlap import pairs as P
from bella_tpu_torch.utils import log as ulog
from test_torch_modes import FIELDS, _assert_same, _detect_both, _port
from torch_test_support import logging_off

# the detection flags of the hifi-ecoli-30x configuration
HIFI = dict(kmer_size=31, error_rate=0.005, bin_size=500, lower_freq=19,
            upper_freq=30)
DETECT_SPANS = {"bella.detect.extract", "bella.detect.count",
                "bella.detect.emit", "bella.detect.chain"}


@functools.lru_cache(maxsize=None)
def hifi_corpus():
    """45 reads of mean 13.5 kbp, at least 5 kbp, 0.5 % error, over a
    20 kbp circular genome (even depth): ~30X."""
    return sample_reads(random_genome(20_000, seed=32), 45, mean_len=13_500,
                        min_len=5000, error_rate=0.005, seed=33,
                        circular=True)[0]


@functools.lru_cache(maxsize=None)
def clr_corpus():
    """tests/test_torch_ladder.py's staged corpus (seed 61)."""
    return sample_reads(random_genome(12_000, seed=61), 60, mean_len=1200,
                        min_len=500, error_rate=0.12, seed=62,
                        circular=False)[0]


def both(rs, **flags):
    """_detect_both with the port's counters: (bella_tpu's result, the
    port's, the port's rung, the port's counters)."""
    with logging_off():
        ulog.reset()
        ref, got, rung = _detect_both(rs, **flags)
        return ref, got, rung, dict(ulog.COUNTS)


def table(pairs) -> np.ndarray:
    return np.stack([getattr(pairs, f).astype(np.int64) for f in FIELDS],
                    axis=1)


def detect(rs, traced=False, **flags):
    """(pairs table, counters, bella.detect.* span names as a list) of the
    port's detect_overlaps on the corpus with `flags`."""
    cfg = BellaConfig(**flags)
    with logging_off():
        ulog.reset()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                got, _, _ = P.detect_overlaps(_port(rs), cfg, device="cpu")
            spans = [e.name() for e in prof.profiler.kineto_results.events()
                     if e.name().startswith("bella.detect.")]
        else:
            got, _, _ = P.detect_overlaps(_port(rs), cfg, device="cpu")
            spans = []
        counts = dict(ulog.COUNTS)
    return table(got), counts, spans


@functools.lru_cache(maxsize=None)
def h_range_flags():
    """HIFI with a budget above the single pass's bytes whose chain share
    holds about a third of the HiFi corpus' candidate rows."""
    rs = hifi_corpus()
    _, counts, _ = detect(rs, **HIFI)
    budget = counts["detect.rows"] * P.CAND_BYTES / P.CHAIN_SHARE / 3.5
    assert (len(rs.codes) - HIFI["kmer_size"] + 1) \
        * P.SINGLE_PASS_BYTES < budget
    return dict(HIFI, total_memory_mb=budget / 1e6)


@pytest.fixture(scope="module")
def hifi():
    return both(hifi_corpus(), **HIFI)


def test_hifi_pairs_match_the_reference(hifi):
    ref, got, rung, counts = hifi
    assert rung == "packed"
    assert got[0].num_pairs > 500
    _assert_same(ref, got)
    assert counts["detect.ranges"] == 1 and counts["detect.rows"] > 0
    # every read under 65,536 bp: the packed seed rule on both sides
    assert int(hifi_corpus().lengths.max()) < 1 << 16


def test_hifi_rows_chained_in_h_ranges_give_the_single_chains_pairs(hifi):
    ref, _, _, once = hifi
    ref_ranged, got, rung, counts = both(hifi_corpus(), **h_range_flags())
    assert rung == "packed"
    assert counts["detect.ranges"] >= 3
    assert counts["detect.rows"] == once["detect.rows"]
    _assert_same(ref_ranged, got)
    _assert_same(ref, got)


def test_clr_corpus_keeps_one_chain():
    rs = clr_corpus()
    ref, got, rung, counts = both(rs)
    assert rung == "packed"
    assert counts["detect.ranges"] == 1
    _assert_same(ref, got)
    # the rows the route reckons hold the rows emitted, with the pairs
    # of two rows in one read that emission drops
    cfg = BellaConfig()
    nnzs = P._count_sorted(*_stream(rs, cfg.kmer_size), cfg.lower_freq,
                           cfg.upper_freq)[5]
    assert 0.9 * P.candidate_rows(nnzs) < counts["detect.rows"] \
        <= P.candidate_rows(nnzs)


def _stream(rs, k):
    lengths = torch.from_numpy(rs.lengths.astype(np.int64))
    offsets = torch.from_numpy(rs.offsets.astype(np.int64))
    return P._extract_kmers(torch.from_numpy(rs.codes), lengths, offsets, k)


@pytest.mark.parametrize("counts,want", [
    ([2], 1), ([2, 3, 5], 1 + 3 + 10), ([30] * 4 + [19], 4 * 435 + 171)])
def test_candidate_rows_counts_each_kmers_pairs(counts, want):
    rows = torch.tensor([c for c in counts for _ in range(c)])
    assert P.candidate_rows(P._lag_sizes(rows, max(counts))) == want


def _per_base(rs, b):
    return dict(total_memory_mb=(len(rs.codes) * b + 1) / 1e6)


SPAN_CASES = {
    # path: (corpus, flags, rung, least chains)
    "single": (hifi_corpus, lambda rs: HIFI, "packed", 1),
    "h-ranges": (hifi_corpus, lambda rs: h_range_flags(), "packed", 3),
    "split": (clr_corpus, lambda rs: _per_base(rs, P.SPLIT_BYTES), "split",
              1),
    "staged": (clr_corpus, lambda rs: _per_base(rs, P.STAGED_BYTES),
               "staged", 2),
}


@pytest.mark.parametrize("path", list(SPAN_CASES))
def test_detect_spans_open_under_a_profiler(path):
    """Each path's stages open their spans, a chain span for each chain
    counted, with the rows and pairs of the path's single chain; the
    single pass sweeps its rows by read (one more emit span) only where
    it chains more than one range."""
    make, flags_of, rung, chains = SPAN_CASES[path]
    rs = make()
    flags = flags_of(rs)
    assert P.detection_rung(_port(rs), BellaConfig(**flags)) == rung
    want, once, _ = detect(rs, **{k: v for k, v in flags.items()
                                  if k != "total_memory_mb"})
    got, counts, spans = detect(rs, traced=True, **flags)
    assert set(spans) == DETECT_SPANS
    ranges = counts["detect.ranges"]
    assert spans.count("bella.detect.chain") == ranges >= chains
    if rung == "packed":
        assert spans.count("bella.detect.emit") == ranges + (ranges > 1)
    assert counts["detect.rows"] == once["detect.rows"]
    np.testing.assert_array_equal(got, want)
