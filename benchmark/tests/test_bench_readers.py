"""The readers of the alignment driver's counters and spans
(benchmark/metrics/align.*.py) on hand-made records: their values,
nothing without the counters or the trace they read, a counter the run
never counted read as 0, and nothing over a zero denominator."""

import pytest

from benchmark import cells
from conftest import ROOT

# a traced window of 2 passes of a d6k-like static run, as run.py
# records it
COUNTS = {"sync.align": 30, "launch.xdrop_static": 10,
          "launch.xdrop_adaptive": 2, "launch.ext_prep": 0,
          "launch.xdrop_static_long_key": 1, "xdrop.extensions": 8_318_380,
          "cascade.extended": 1_289_432, "cascade.settled": 905_460}
TRACE = {"busy_s": 7.0, "window_s": 10.0,
         "idle_in_span": {"bella.alignment": 1.5, "bella.align.batch": 0.2}}


def reader(name):
    return cells._reader(ROOT, name)


def record(counts=COUNTS, trace=TRACE, passes=2):
    return {"passes": passes, "counts": counts, "trace": trace}


@pytest.mark.parametrize("name,want", [
    ("align.syncs_per_pass", 15),
    # the long-key launch is one of the ten static ones
    ("align.launches_per_pass", 6),
    ("align.extensions_per_launch", 8_318_380 / 12),
    ("align.rescue_settled_pct", 100 * 905_460 / 1_289_432),
    ("align.idle_s_per_pass", 0.75),
])
def test_reader_values(name, want):
    assert reader(name)(record()) == pytest.approx(want)


@pytest.mark.parametrize("name", [
    "align.syncs_per_pass", "align.launches_per_pass",
    "align.extensions_per_launch", "align.rescue_settled_pct"])
def test_counter_readers_read_nothing_without_counters(name):
    rec = record()
    del rec["counts"]
    assert reader(name)(rec) is None
    assert reader(name)(record(counts=None)) is None


@pytest.mark.parametrize("name,want", [
    ("align.syncs_per_pass", 0), ("align.launches_per_pass", 0),
    ("align.extensions_per_launch", None),
    ("align.rescue_settled_pct", None)])
def test_counter_absent_from_counts_reads_zero(name, want):
    # a run that counted nothing: no sync, no launch, no cascade
    assert reader(name)(record(counts={})) == want


def test_cpu_run_counts_extensions_but_no_launch():
    counts = {"xdrop.extensions": 960, "cascade.extended": 10,
              "cascade.settled": 0}
    rec = record(counts=counts)
    assert reader("align.launches_per_pass")(rec) == 0
    assert reader("align.extensions_per_launch")(rec) is None
    # nothing settled reads 0, which is a reading
    assert reader("align.rescue_settled_pct")(rec) == 0


@pytest.mark.parametrize("name", [
    "align.syncs_per_pass", "align.launches_per_pass",
    "align.idle_s_per_pass"])
def test_no_pass_reads_nothing(name):
    assert reader(name)(record(passes=0)) is None


@pytest.mark.parametrize("trace", [
    None,                                         # untraced
    dict(TRACE, busy_s=None),                     # no card work recorded
    dict(TRACE, idle_in_span={}),                 # no bella.alignment span
    {"busy_s": 7.0, "window_s": 10.0},            # a trace without the split
])
def test_idle_reader_reads_nothing_without_its_trace(trace):
    assert reader("align.idle_s_per_pass")(record(trace=trace)) is None
