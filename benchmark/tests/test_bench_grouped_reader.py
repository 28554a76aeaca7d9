"""The reader of align.grouped_pct (benchmark/metrics/align.grouped_pct.py)
on hand-made records: its value from the port's counters, 0 where the
launches took no grouped tile, and nothing without the counters, without
the grouped counter (a port that does not count it) or over no
extension."""

import pytest

from benchmark import cells
from conftest import ROOT

# a d6k-like static run: the first level and band 256 in the grouped tile
COUNTS = {"launch.xdrop_static": 5, "xdrop.extensions": 4_160_000,
          "xdrop.grouped_extensions": 3_500_000}


def read(counts):
    return cells._reader(ROOT, "align.grouped_pct")(
        {"passes": 2, "counts": counts})


def test_value_from_counts():
    assert read(COUNTS) == pytest.approx(100 * 3_500_000 / 4_160_000)


def test_adaptive_run_reads_zero():
    # every launch counted, none in the grouped tile
    assert read({"launch.xdrop_adaptive": 2, "xdrop.extensions": 5_739_512,
                 "xdrop.grouped_extensions": 0}) == 0


@pytest.mark.parametrize("counts", [
    None, {},                                         # no counters
    {"xdrop.extensions": 960},                        # no grouped counter
    dict(COUNTS, **{"xdrop.extensions": 0}),          # no extension
    {"xdrop.grouped_extensions": 0}])
def test_reads_nothing(counts):
    assert read(counts) is None
    rec = {"passes": 2}
    assert cells._reader(ROOT, "align.grouped_pct")(rec) is None
