"""The port's spans and counters (bella_tpu_torch/utils/log.py), on the
CPU.

With no profiler running, phase() and span() enter no record_function.
Under a CPU torch.profiler run of run_pipeline on a corpus whose pairs
drift past the static band (so the cascade and the tail run), the
phases appear as bella.<phase> spans and every bella.align.* span lies
inside bella.alignment. count() from four threads at once adds up, and
reset() clears the phase seconds and the counters together. The
cascade's counters agree with AlignmentResult.rescue_levels. A host
read of a card tensor counts one sync, of a host tensor none.
"""

import sys
import threading

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from bella_tpu_torch.align import pallas_xdrop as P
from bella_tpu_torch.config import BellaConfig
from bella_tpu_torch.pipeline import run_pipeline
from bella_tpu_torch.utils import log as ulog
from torch_test_support import logging_off

# the static path with the cascade (band 256) and the tail
CONFIG = dict(pallas_band=128, rescue_ceiling=256)
PHASES = ("overlapDetection", "alignment", "decision", "outputting")
ALIGN_SPANS = ("upload", "batch", "collect", "cascade", "tail")


@pytest.fixture(scope="module")
def traced():
    """(result, bella.* spans as (name, start ns, end ns), counters) of
    one profiled run_pipeline on the drift corpus."""
    from test_torch_adaptive import drift_corpus

    reads = drift_corpus()
    with logging_off():
        ulog.reset()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            res = run_pipeline(reads, BellaConfig(**CONFIG), device="cpu")
        counts = dict(ulog.COUNTS)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
             for e in prof.profiler.kineto_results.events()
             if e.name().startswith(ulog.SPAN_PREFIX)]
    return res, spans, counts


def test_no_record_function_without_a_profiler(monkeypatch):
    entered = []

    def record_function(name):
        entered.append(name)
        raise AssertionError(f"entered {name} with no profiler running")

    monkeypatch.setattr(ulog._profiler, "record_function", record_function)
    assert not ulog._profiler._is_profiler_enabled
    with logging_off():
        with ulog.phase("testPhase"):
            with ulog.span("test.part"):
                pass
    assert entered == []
    assert ulog.PHASE_SECONDS["testPhase"] >= 0


def test_phase_and_span_names_under_a_profiler():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with logging_off(), ulog.phase("testPhase"):
            with ulog.span("test.part"):
                torch.ones(4).sum()
    names = {e.name() for e in prof.profiler.kineto_results.events()}
    assert {"bella.testPhase", "bella.test.part"} <= names


def test_pipeline_phases_and_align_spans_nest(traced):
    res, spans, _ = traced
    names = {n for n, _, _ in spans}
    assert {f"bella.{p}" for p in PHASES} <= names
    assert {f"bella.align.{p}" for p in ALIGN_SPANS} <= names
    assert res.alignment.rescue_levels and len(res.alignment.tail_pairs)
    outer = [(s, e) for n, s, e in spans if n == "bella.alignment"]
    assert len(outer) == 1
    for n, s, e in spans:
        if n.startswith("bella.align."):
            assert any(a <= s and e <= b for a, b in outer), n
    # no align span outside the alignment phase's
    det = [(s, e) for n, s, e in spans if n == "bella.overlapDetection"]
    assert all(e <= outer[0][0] for _, e in det)


def test_cascade_counters_match_rescue_levels(traced):
    res, _, counts = traced
    extended = sum(c for _, c in res.alignment.rescue_levels)
    assert counts["cascade.extended"] == extended > 0
    # pairs that left the band edge, and those the tail took: each pair
    # of the cascade does one or the other once
    assert 0 <= counts["cascade.settled"] <= extended
    assert (counts["cascade.settled"] + len(res.alignment.tail_pairs)
            <= extended)
    # nothing on the card, so no host sync counted
    assert "sync.align" not in counts


def test_count_from_threads_adds_up_and_reset_clears_both():
    ulog.reset()
    n, threads = 5000, 4
    was = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        workers = [threading.Thread(
            target=lambda: [ulog.count("test.n") for _ in range(n)])
            for _ in range(threads)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
        assert not any(w.is_alive() for w in workers)
    finally:
        sys.setswitchinterval(was)
    ulog.count("test.m", 7)
    assert ulog.COUNTS["test.n"] == n * threads
    assert ulog.COUNTS["test.m"] == 7
    ulog.PHASE_SECONDS["testPhase"] = 1.0
    ulog.reset()
    assert ulog.COUNTS == {} and ulog.PHASE_SECONDS == {}


class _OnCard(torch.Tensor):
    """A host tensor that reports itself on the card."""

    @property
    def is_cuda(self):
        return True


def test_host_read_of_a_card_tensor_counts_a_sync():
    ulog.reset()
    t = torch.from_numpy(np.array([3, 9], np.int32))
    assert P.host_int(t.max()) == 9
    assert "sync.align" not in ulog.COUNTS
    assert P.host_int(t.as_subclass(_OnCard).max()) == 9
    assert ulog.COUNTS["sync.align"] == 1
