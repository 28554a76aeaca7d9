"""The card's idle time split by the port's bella.* spans
(benchmark/program_spans.py) on synthetic events: each span's share,
each idle second given to its innermost span, the shares adding up to
the window's idle time, and the range the card mirrors from a bella.*
host span counted as no work, here and in tracing.summarise; and each
span's host seconds in the window."""

import pytest

from benchmark import program_spans, tracing

MS = 1_000_000


class Ev:
    """A stand-in for torch's kineto event, with is_user_annotation (true
    for the ranges the card mirrors from record_function)."""

    def __init__(self, name, card, start, end, annotation=False):
        self._n, self._c, self._s, self._e = name, card, start, end
        self._a = annotation

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._c else "DeviceType.CPU"

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def is_user_annotation(self):
        return self._a


def events():
    host = [(tracing.WINDOW, 0, 100), ("bella.overlapDetection", 0, 20),
            ("bella.alignment", 20, 80), ("bella.align.upload", 20, 25),
            ("bella.align.batch", 25, 45), ("bella.align.batch", 45, 70),
            ("bella.align.collect", 70, 75), ("bella.decision", 80, 90),
            (tracing.ALIGN, 20, 80)]
    card = [("k1", 30, 40), ("k1", 50, 60), ("Memcpy HtoD", 62, 66),
            ("k2", 95, 105)]          # cut at the window's end
    return ([Ev(n, False, s * MS, e * MS) for n, s, e in host]
            + [Ev(n, True, s * MS, e * MS) for n, s, e in card]
            # the card's mirror of the host span: no work
            + [Ev("bella.alignment", True, 20 * MS, 80 * MS, True)])


def test_idle_split_by_span_and_innermost():
    got = program_spans.idle_split(tracing.read(events()))
    # idle: [0, 30], [40, 50], [60, 62], [66, 95] ms
    assert got["idle_s"] == pytest.approx(0.071)
    want_in = {"bella.overlapDetection": 20, "bella.alignment": 36,
               "bella.align.upload": 5, "bella.align.batch": 21,
               "bella.align.collect": 5, "bella.decision": 10}
    assert got["idle_in_span"] == pytest.approx(
        {n: v / 1e3 for n, v in want_in.items()})
    want_inner = {"bella.overlapDetection": 20, "bella.alignment": 5,
                  "bella.align.upload": 5, "bella.align.batch": 21,
                  "bella.align.collect": 5, "bella.decision": 10,
                  program_spans.OUTSIDE: 5}
    assert got["idle_by_innermost"] == pytest.approx(
        {n: v / 1e3 for n, v in want_inner.items()})
    assert sum(got["idle_by_innermost"].values()) == pytest.approx(
        got["idle_s"])


def test_mirrored_program_span_is_no_work_in_summarise():
    s = tracing.summarise(tracing.read(events()))
    assert s["busy_s"] == pytest.approx(0.029)
    assert s["window_s"] - s["busy_s"] == pytest.approx(
        program_spans.idle_split(tracing.read(events()))["idle_s"])
    # only k1 lies inside the alignment driver's span
    assert s["align_kernel_s"] == pytest.approx(0.020)
    assert "bella.alignment" not in {n for n, _ in s["device_ops"]}


def test_nested_spans_that_start_together_give_idle_to_the_inner():
    evs = [Ev(tracing.WINDOW, False, 0, 10 * MS),
           Ev("bella.alignment", False, 0, 10 * MS),
           Ev("bella.align.batch", False, 0, 4 * MS),
           Ev("k", True, 4 * MS, 10 * MS)]
    got = program_spans.idle_split(tracing.read(evs))
    assert got["idle_by_innermost"] == pytest.approx(
        {"bella.align.batch": 0.004})
    assert got["idle_in_span"]["bella.alignment"] == pytest.approx(0.004)


def test_span_s_is_each_names_union_inside_the_window():
    evs = events() + [
        # nested in a span of its name: counted once
        Ev("bella.align.batch", False, 30 * MS, 40 * MS),
        # cut at the window's end
        Ev("bella.outputting", False, 90 * MS, 110 * MS),
        # outside the window
        Ev("bella.fastqParsing", False, 120 * MS, 130 * MS)]
    got = program_spans.span_s(tracing.read(evs))
    want = {"bella.overlapDetection": 20, "bella.alignment": 60,
            "bella.align.upload": 5, "bella.align.batch": 45,
            "bella.align.collect": 5, "bella.decision": 10,
            "bella.outputting": 10}
    assert got == pytest.approx({n: v / 1e3 for n, v in want.items()})


def test_a_trace_without_the_window_raises():
    evs = tracing.read([Ev("bella.alignment", False, 0, 1)])
    for fn in (program_spans.idle_split, program_spans.span_s):
        with pytest.raises(RuntimeError, match=tracing.WINDOW):
            fn(evs)
