"""The traced run: spans around the pipeline's calls into each layer, set
from the benchmark's own files, and what the profiler's record gives.

``layer_spans`` wraps, for the length of a ``with`` block, the functions
through which ``bella_tpu_torch.pipeline`` enters each layer in a
``torch.profiler.record_function`` span named after the layer (the port
has no switch for it; the attributes are put back on exit).
``read`` takes the profiler's kineto events once, as tuples, for
``summarise`` here and for ``program_spans``. ``summarise`` gives the
card's busy time over the window (the union of its kernels', copies' and
sets' intervals, as scripts/torch_align_profile.py's ``device_busy``
takes it), the device time of the kernels inside the alignment spans,
the device operations that took the most time, and the longest idle
gaps, each named by the layer span it falls in.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict

WINDOW = "bench.window"
ALIGN = "alignment driver"
# (module, attribute): the layer whose span the call opens. The pipeline
# calls the writers through the module `writers`, and the rest through
# the names it imported.
LAYER_CALLS = (
    ("bella_tpu_torch.pipeline", "read_files", "ingest"),
    ("bella_tpu_torch.pipeline", "detect_overlaps", "detection"),
    ("bella_tpu_torch.pipeline", "align_candidates", ALIGN),
    ("bella_tpu_torch.pipeline", "post_align_decision", "decision and rows"),
    ("bella_tpu_torch.io.writers", "write_m4_native", "decision and rows"),
)
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")
SPANS = {WINDOW} | {c[2] for c in LAYER_CALLS}
TOP = 10


@contextlib.contextmanager
def layer_spans():
    import importlib

    from torch.profiler import record_function

    saved = []
    try:
        for mod_name, attr, layer in LAYER_CALLS:
            mod = importlib.import_module(mod_name)
            fn = getattr(mod, attr)

            def wrapped(*a, __fn=fn, __layer=layer, **kw):
                with record_function(__layer):
                    return __fn(*a, **kw)

            functools.update_wrapper(wrapped, fn)
            saved.append((mod, attr, fn))
            setattr(mod, attr, wrapped)
        yield
    finally:
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)


def _kind(e, on_card: bool) -> str:
    """The event's activity type (torch's kineto event carries none): a
    card event's from its name: user annotations (the mirrored spans of
    record_function), copies, sets, else kernels."""
    if not on_card:
        return "cpu"
    name = e.name()
    if (getattr(e, "is_user_annotation", lambda: False)()
            or name in SPANS):
        return "gpu_user_annotation"
    if name.startswith("Memcpy"):
        return "gpu_memcpy"
    if name.startswith("Memset"):
        return "gpu_memset"
    return "kernel"


def read(kineto_events) -> list:
    """(name, on the card, activity type, start ns, end ns) of each event
    of the profiler's kineto record (read directly: building the
    profiler's event tree takes minutes for a window's events)."""
    out = []
    for e in kineto_events:
        on_card = str(e.device_type()).endswith("CUDA")
        s = e.start_ns()
        out.append((e.name(), on_card, _kind(e, on_card), s,
                    s + e.duration_ns()))
    return out


def window(events) -> tuple:
    """(start ns, end ns) of the host's WINDOW span in read events."""
    win = [(s, t) for n, on_card, _, s, t in events
           if n == WINDOW and not on_card]
    if not win:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return min(s for s, _ in win), max(t for _, t in win)


def _union(iv):
    """Merged [start, end] intervals of a sorted list."""
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def summarise(events) -> dict:
    """What the traced window's events (as ``read`` gives them) give
    (times in seconds): window_s, busy_s (None where the card recorded no
    work), align_kernel_s, device_ops and idle_gaps (the TOP largest,
    [name, seconds])."""
    w0, w1 = window(events)
    host = [e for e in events if not e[1]]
    layers = sorted((e[3], e[4], e[0]) for e in host
                    if e[0] in SPANS and e[0] != WINDOW)
    # kernels, copies and sets on the card (not the mirrored ranges of
    # record_function, which last as long as the host's span)
    work = [e for e in events if e[1] and e[2] in DEVICE_WORK]
    busy_iv = _union(sorted((max(s, w0), min(t, w1))
                            for _, _, _, s, t in work
                            if min(t, w1) > max(s, w0)))
    busy = sum(e - s for s, e in busy_iv)
    # kernels inside the alignment spans: the driver ends on host arrays,
    # so what it launched has run before its span closes
    align = [(s, e) for s, e, n in layers if n == ALIGN]
    starts = [s for s, _ in align]
    align_ns = 0
    by_op = defaultdict(int)
    for name, _, kind, s, t in work:
        by_op[name] += t - s
        i = bisect.bisect_right(starts, s) - 1
        if kind == "kernel" and i >= 0 and t <= align[i][1]:
            align_ns += t - s
    gaps = []
    prev = w0
    for s, e in busy_iv + [[w1, w1]]:
        if s > prev:
            gaps.append((s - prev, _layer_at((prev + s) / 2, layers)))
        prev = max(prev, e)
    gaps.sort(reverse=True)
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    return dict(
        window_s=(w1 - w0) / 1e9,
        busy_s=busy / 1e9 if work else None,
        align_kernel_s=align_ns / 1e9,
        device_ops=[[n, ns / 1e9] for n, ns in ops],
        idle_gaps=[[n, ns / 1e9] for ns, n in gaps[:TOP]],
    )


def _layer_at(t: float, layers) -> str:
    """The layer whose span holds host time t, or "outside the layers"."""
    name = "outside the layers"
    for s, e, n in layers:
        if s > t:
            break
        if t <= e:
            name = n
    return name
