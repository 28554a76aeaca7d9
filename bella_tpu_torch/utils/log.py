"""Structured run logging: the printLog macro + omp_get_wtime() phase
spans of the reference (include/common/common.h:40-44 and the timers
sprinkled through src/main.cpp / include/overlap.hpp), as one utility;
and the port's one set of spans and counters.

* ``phase(name)`` times a pipeline phase on the host clock into
  ``PHASE_SECONDS`` and logs it; ``span(name)`` marks a part below the
  phases. While a ``torch.profiler`` run is on, each opens a
  ``record_function`` span named ``bella.<name>``, so the spans share
  the profiler's clock with the card's kernels; otherwise neither enters
  one (a check of the profiler's flag, not a span, is all they cost).
* ``count(name, n)`` adds to ``COUNTS``: kernel launches by kernel
  (``launch.<kernel>``), the aligner's blocking host reads of card
  tensors (``sync.align``), the cascade's pairs (``cascade.extended``,
  ``cascade.settled``), detection's candidate rows and chains
  (``detect.rows``, ``detect.ranges``). Shards on distinct cards count from their own
  threads at once, so the store takes a lock.
* ``reset()`` clears both stores.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from typing import Dict

import torch.autograd.profiler as _profiler

SPAN_PREFIX = "bella."
_ENABLED = True
PHASE_SECONDS: Dict[str, float] = {}
COUNTS: Dict[str, int] = {}
_COUNT_LOCK = threading.Lock()
_NO_SPAN = contextlib.nullcontext()


def set_enabled(flag: bool) -> None:
    global _ENABLED
    _ENABLED = flag


def log(name: str, value) -> None:
    if _ENABLED:
        print(f"INFO:\t{name} = {value}", file=sys.stderr, flush=True)


def span(name: str):
    """A ``record_function`` span ``bella.<name>`` while a profiler runs,
    else a context that does nothing."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(SPAN_PREFIX + name)
    return _NO_SPAN


@contextlib.contextmanager
def phase(name: str):
    """Time a pipeline phase; records into PHASE_SECONDS and logs."""
    t0 = time.perf_counter()
    try:
        with span(name):
            yield
    finally:
        dt = time.perf_counter() - t0
        PHASE_SECONDS[name] = PHASE_SECONDS.get(name, 0.0) + dt
        log(f"{name}Time", f"{dt:.3f} seconds")


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name`."""
    with _COUNT_LOCK:
        COUNTS[name] = COUNTS.get(name, 0) + n


def reset() -> None:
    """Clear PHASE_SECONDS and COUNTS."""
    with _COUNT_LOCK:
        COUNTS.clear()
    PHASE_SECONDS.clear()
