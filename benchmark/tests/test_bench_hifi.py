"""The HiFi cell and detection's readers on the CPU: hifi-ecoli-30x.h13k
loads with its configuration, its traffic mix and its 10,200 fixed read
lengths (every one under 65,536 bp, so the packed seed rule holds); the
three readers of detection's counters and idle time read hand-made
records, and read nothing where the record lacks what they read (a port
without the counters, an untraced run, no pass, no detection seconds).
The plain reference gives the port's detection pairs at the cell's k 31
and bounds [19, 30], on a seeded corpus of the mix's shape."""

import json

import numpy as np
import pytest
import torch

from benchmark import cells
from benchmark.gen.simulate import random_genome, sample_reads
from benchmark.reference import detect as R
from conftest import ROOT

torch.set_num_threads(1)

# a traced window of 2 passes of an h13k-like run, as run.py records it
COUNTS = {"detect.rows": 2_100_000_000, "detect.ranges": 6,
          "sync.align": 10}
PHASE_S = {"fastqParsing": 0.6, "overlapDetection": 8.0,
           "alignment": 2.0}
TRACE = {"busy_s": 9.0, "window_s": 12.0,
         "idle_in_span": {"bella.overlapDetection": 1.2,
                          "bella.alignment": 0.4}}
READERS = ("detect.ranges_per_pass", "detect.mrows_per_s",
           "detect.idle_s_per_pass")


def reader(name):
    return cells._reader(ROOT, name)


def record(counts=COUNTS, trace=TRACE, passes=2, phase_s=PHASE_S):
    return {"passes": passes, "counts": counts, "trace": trace,
            "phase_s": phase_s}


def test_hifi_cell_loads_with_its_config_traffic_and_lengths():
    cell = cells.load("hifi-ecoli-30x.h13k")
    assert cell.chips == 1
    flags = cell.config["flags"]
    assert (flags["kmer_size"], flags["error_rate"], flags["lower_freq"],
            flags["upper_freq"]) == (31, 0.005, 19, 30)
    assert cell.config["reduced"] == []
    reads = cell.traffic["reads"]
    lengths = reads["lengths"]
    assert len(lengths) == reads["count"] == 10_200
    assert sum(lengths) == 137_732_095
    assert min(lengths) >= reads["min_len"] == 5000
    assert max(lengths) < 1 << 16
    assert {m.name for m in cell.per_layer} >= set(READERS)
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    assert {m["name"]: m["layer"] for m in spec["per_layer"]
            if m["name"] in READERS} == dict.fromkeys(READERS, "detection")


def test_hifi_bounds_are_the_binomial_models_at_depth_30():
    from bella_tpu_torch.kmers.bound import compute_lower, compute_upper

    flags = cells.load("hifi-ecoli-30x.h13k").config["flags"]
    args = (30, flags["error_rate"], flags["kmer_size"], 0.002)
    assert (compute_lower(*args), compute_upper(*args)) == (
        flags["lower_freq"], flags["upper_freq"])


def test_reference_matches_the_port_at_k31():
    """89 reads of gamma(16) lengths, mean 13.5 kbp, at least 5 kbp (the
    h13k mix's shape), 0.5 % error, over a 40 kbp linear genome: 30X.
    Every read sampled: each pair of the port's detect_overlaps, field
    for field."""
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.fastq import ReadSet
    from bella_tpu_torch.overlap.pairs import detect_overlaps
    from bella_tpu_torch.utils import log

    flags = cells.load("hifi-ecoli-30x.h13k").config["flags"]
    lengths = np.maximum(np.random.default_rng(31).gamma(
        16, 13500 / 16, 89), 5000).astype(np.int64)
    c = sample_reads(random_genome(40_000, seed=32), 89, 13500, 5000,
                     0.005, seed=33, circular=False, lengths=lengths)
    was = log._ENABLED
    log.set_enabled(False)
    try:
        got, _, _ = detect_overlaps(ReadSet(c.names, c.codes, c.offsets),
                                    BellaConfig(**flags), device="cpu")
    finally:
        log.set_enabled(was)
    table = np.stack([getattr(got, f).astype(np.int64) for f in R.FIELDS], 1)
    want = R.detect_sample(c.codes, c.offsets, np.ones(c.num_reads, bool),
                           flags, "cpu")
    assert len(want) > 1000
    assert R.packed_rule(c.lengths, flags["bin_size"], flags["upper_freq"])
    assert np.array_equal(table, want.table())


@pytest.mark.parametrize("name,want", [
    ("detect.ranges_per_pass", 3),
    ("detect.mrows_per_s", 2_100 / 8.0),
    ("detect.idle_s_per_pass", 0.6),
])
def test_detect_reader_values(name, want):
    assert reader(name)(record()) == pytest.approx(want)


def test_detection_seconds_are_detect_s_per_pass_phases():
    phase_s = dict(PHASE_S, kmerCounting=1.0, coverageEstimation=1.0)
    assert reader("detect.mrows_per_s")(
        record(phase_s=phase_s)) == pytest.approx(2_100 / 10.0)


@pytest.mark.parametrize("name", ["detect.ranges_per_pass",
                                  "detect.mrows_per_s"])
@pytest.mark.parametrize("counts", [
    None,                                   # a record without counters
    {},                                     # counted nothing
    {"sync.align": 10},                     # a port that counts no rows
])
def test_counter_readers_read_nothing_without_their_counter(name, counts):
    rec = record(counts=counts)
    assert reader(name)(rec) is None
    del rec["counts"]
    assert reader(name)(rec) is None


@pytest.mark.parametrize("name,rec", [
    ("detect.ranges_per_pass", record(passes=0)),
    ("detect.mrows_per_s", record(phase_s={"alignment": 2.0})),
    ("detect.idle_s_per_pass", record(passes=0)),
])
def test_no_pass_or_detection_seconds_reads_nothing(name, rec):
    assert reader(name)(rec) is None


@pytest.mark.parametrize("trace", [
    None,                                          # untraced
    dict(TRACE, busy_s=None),                      # no card work recorded
    dict(TRACE, idle_in_span={"bella.alignment": 0.4}),  # no such span
    {"busy_s": 9.0, "window_s": 12.0},             # a trace without split
])
def test_idle_reader_reads_nothing_without_its_trace(trace):
    assert reader("detect.idle_s_per_pass")(record(trace=trace)) is None
