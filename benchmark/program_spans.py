"""The card's idle time of a traced window split by the port's own spans,
and the host time of each span.

bella_tpu_torch opens a ``record_function`` span ``bella.<name>`` for each
phase and for the alignment driver's parts while a profiler runs
(bella_tpu_torch/utils/log.py). ``idle_split`` takes the window's idle
intervals as ``tracing.summarise`` does (the window less the union of
the card's kernels, copies and sets; the ranges the card mirrors from
host spans are no work) and gives

* ``idle_in_span``: for each ``bella.`` span name, the idle seconds
  inside its intervals (exact intersection; a parent's value holds its
  children's);
* ``idle_by_innermost``: each idle second given to the innermost
  ``bella.`` span open over it (the one opened last), else to
  ``OUTSIDE``; its values add up to ``idle_s``, the window's idle time.

``span_s`` gives each ``bella.`` span name's host seconds inside the
window: the union of its intervals, so a span that opens inside another
of its name is not counted twice. Both take the events as
``tracing.read`` gives them.
"""

from __future__ import annotations

from collections import defaultdict

from benchmark.tracing import DEVICE_WORK, _union, window

PREFIX = "bella."
OUTSIDE = "outside the program"


def _idle(work, w0: int, w1: int) -> list:
    """[start, end] intervals of the window the card did no work in."""
    busy = _union(sorted((max(s, w0), min(t, w1)) for s, t in work
                         if min(t, w1) > max(s, w0)))
    out, prev = [], w0
    for s, e in busy + [[w1, w1]]:
        if s > prev:
            out.append((prev, s))
        prev = max(prev, e)
    return out


def _overlap(a, b) -> int:
    """Length of the intersection of two sorted lists of disjoint
    intervals."""
    i = j = total = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def _innermost(idle, spans) -> dict:
    """Idle ns by the innermost span open over them: a sweep over every
    boundary, the open span that started last (of two that started
    together, the one that ends first) taking each piece."""
    marks = sorted({t for iv in idle for t in iv}
                   | {t for s, e, _ in spans for t in (s, e)})
    starts = defaultdict(list)
    for k, (s, _, _) in enumerate(spans):
        starts[s].append(k)
    out = defaultdict(int)
    open_, i = set(), 0
    for a, b in zip(marks, marks[1:]):
        open_.update(starts.get(a, ()))
        open_ = {k for k in open_ if spans[k][1] > a}
        while i < len(idle) and idle[i][1] <= a:
            i += 1
        if i < len(idle) and idle[i][0] <= a:
            name = (spans[max(open_, key=lambda k: (spans[k][0],
                                                    -spans[k][1]))][2]
                    if open_ else OUTSIDE)
            out[name] += b - a
    return out


def _spans(events, w0: int, w1: int) -> list:
    """(start, end, name) of the host's bella.* spans, cut to the window,
    sorted."""
    return sorted((max(s, w0), min(t, w1), n)
                  for n, on_card, _, s, t in events
                  if not on_card and n.startswith(PREFIX)
                  and min(t, w1) > max(s, w0))


def _by_name(spans) -> dict:
    """Each span name's merged intervals."""
    by_name = defaultdict(list)
    for s, e, n in spans:
        by_name[n].append((s, e))
    return {n: _union(iv) for n, iv in sorted(by_name.items())}


def span_s(events) -> dict:
    """Host seconds of each bella.* span name inside the traced window,
    whose span tracing.WINDOW the events must hold."""
    w0, w1 = window(events)
    return {n: sum(e - s for s, e in iv) / 1e9
            for n, iv in _by_name(_spans(events, w0, w1)).items()}


def idle_split(events) -> dict:
    """idle_s, idle_in_span and idle_by_innermost (seconds) of the traced
    window, whose span tracing.WINDOW the events must hold."""
    w0, w1 = window(events)
    idle = _idle([(s, t) for _, on_card, kind, s, t in events
                  if on_card and kind in DEVICE_WORK], w0, w1)
    spans = _spans(events, w0, w1)
    return dict(
        idle_s=sum(e - s for s, e in idle) / 1e9,
        idle_in_span={n: _overlap(idle, iv) / 1e9
                      for n, iv in _by_name(spans).items()},
        idle_by_innermost={n: ns / 1e9 for n, ns in
                           sorted(_innermost(idle, spans).items())},
    )
