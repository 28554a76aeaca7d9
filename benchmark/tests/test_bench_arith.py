"""The yardstick's arithmetic: the x-drop least time against chip_smoke's
bench bound, the busy union of the traced window on synthetic events,
the check's levels and its sample drawn by level, and its verdict."""

import numpy as np
import pytest

from benchmark import check, peaks, tracing
from benchmark.reference import detect as R

H100 = "NVIDIA H100 80GB HBM3"


def test_xdrop_least_time_matches_the_bench_bound():
    # the bench corpus: 195,798,404 aligned bases, 7,449,164 bases of
    # reads; chip_smoke.py's K1 bound from its step counts: 1.8756 ms
    least = peaks.xdrop_least_s(195_798_404, 128, 7_449_164 // 4, H100)
    assert least == pytest.approx(5 * 128 * 195_798_404 / 67e12)
    assert least * 1e3 == pytest.approx(1.8756, rel=0.005)
    # the operations bind: the packed reads are 1.9 MB
    assert least > 7_449_164 / 4 / 3.35e12
    assert peaks.xdrop_least_s(1, 128, 1, "cpu") is None


class Ev:
    """A stand-in for torch's kineto event (the torch 2.11 surface: no
    activity type)."""

    def __init__(self, name, card, start, end):
        self._n, self._c, self._s, self._e = name, card, start, end

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s


def test_busy_union_and_gaps_on_synthetic_events():
    ms = 1_000_000
    evs = [
        Ev(tracing.WINDOW, False, 0, 100 * ms),
        Ev("ingest", False, 0, 20 * ms),
        Ev(tracing.ALIGN, False, 20 * ms, 80 * ms),
        Ev("decision and rows", False, 80 * ms, 100 * ms),
        # the mirrored span of the window on the card is no work
        Ev(tracing.WINDOW, True, 0, 100 * ms),
        Ev("k1", True, 25 * ms, 40 * ms),
        Ev("k1", True, 35 * ms, 50 * ms),     # overlaps the one before
        Ev("Memcpy HtoD", True, 60 * ms, 70 * ms),
        Ev("k2", True, 95 * ms, 105 * ms),    # cut at the window's end
    ]
    s = tracing.summarise(tracing.read(evs))
    assert s["window_s"] == pytest.approx(0.1)
    assert s["busy_s"] == pytest.approx(0.040)
    # kernels inside the alignment span: 15 + 15 ms; not the copy, not k2
    assert s["align_kernel_s"] == pytest.approx(0.030)
    assert s["idle_gaps"][0] == ["ingest", pytest.approx(0.025)]
    assert [g[0] for g in s["idle_gaps"]] == [
        "ingest", "decision and rows", tracing.ALIGN]
    assert s["device_ops"][0] == ["k1", pytest.approx(0.030)]


def test_no_card_work_gives_no_busy_time():
    s = tracing.summarise(tracing.read([Ev(tracing.WINDOW, False, 0, 10)]))
    assert s["busy_s"] is None


FLAGS = {"pallas_band": 128, "rescue_ceiling": 2048}


def test_levels_follow_the_cascades_band_edges():
    assert check.bands(FLAGS) == [128, 256, 512, 1024, 2048]
    got = check.levels(FLAGS, [0, 61, 62, 125, 126, 1021, 1022, 5000])
    assert got.tolist() == [0, 0, 1, 1, 2, 4, 5, 5]


def test_the_sample_holds_every_level():
    n = 4000
    level = np.zeros(n, np.int64)
    level[:12] = 5        # 0.3 % of the pairs, past the widest band
    level[12:20] = 3      # 0.2 %
    level[20:400] = 1
    ref = R.Pairs(*(np.arange(n) for _ in R.FIELDS))
    sub, pick = check.pick_pairs(ref, level, 100, 10,
                                 np.random.default_rng(1))
    assert len(set(pick.tolist())) == len(pick)
    assert np.array_equal(sub.read_h, pick)
    by = np.bincount(level[pick], minlength=6)
    assert by[5] == 10 and by[3] == 8 and by[1] >= 10
    assert len(pick) == 100 + 10 + 8 + 10


def test_verdict():
    assert check.verdict([("a", 0, 0), ("b", 2, 3)])
    assert not check.verdict([("a", 0, 0), ("b", 1, 0)])
    assert not check.verdict([])
