"""Measurement helpers shared by ``chip_smoke.py``, ``bench_torch.py`` and
the ``scripts/torch_*`` profilers: the card's name and power limit, CUDA
event timing, and context managers that wrap functions of the package
from outside for the duration of a ``with`` block.

The package has no switch for any of them: a wrapper replaces a module
attribute (or a method of ``torch.Tensor``) on entry and restores it on
exit, so the code measured is the code users run. Nothing here runs
when the module is imported.

They live in the package, though only measurement uses them, because
every caller already imports the package and finds it from anywhere:
``chip_smoke.py`` and ``bench_torch.py`` at the root, the profilers in
``scripts/``, and the tests. ``kernel_spans`` wraps the aligner's
launchers (x-drop and extension prep) and ``ShardGroup.map``, so it imports ``align`` and
``parallel``; it does so inside the function, and ``utils`` imports
neither when it is loaded.
"""

from __future__ import annotations

import contextlib
import importlib
import subprocess
import threading

import numpy as np


def nvidia_smi() -> str:
    """The first card's name and power limit as nvidia-smi gives them
    (``NVIDIA H100 80GB HBM3, 700.00 W``), or "unknown"."""
    try:
        r = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        )
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    lines = r.stdout.strip().splitlines()
    return lines[0] if r.returncode == 0 and lines else "unknown"


def device_info(dev) -> dict:
    """name, power limit and count of the cards (nvidia-smi's name and
    limit), or the CPU's stand-in for a CPU run."""
    import torch

    if dev.type != "cuda":
        return dict(name="cpu", power_limit=None, count=0)
    smi = nvidia_smi()
    name, _, limit = smi.partition(", ")
    return dict(name=name or torch.cuda.get_device_name(dev),
                power_limit=limit or None, count=torch.cuda.device_count(),
                nvidia_smi=smi)


def cuda_times(fn, reps: int = 3, warmups: int = 1) -> list:
    """Device time of each of `reps` calls of fn() in ms (CUDA events
    around each call), after `warmups` calls."""
    import torch

    for _ in range(warmups):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return times


def cuda_ms(fn, reps: int = 3, warmups: int = 1) -> float:
    """Median of cuda_times(fn, reps, warmups)."""
    return float(np.median(cuda_times(fn, reps, warmups)))


_INHERITED = object()


@contextlib.contextmanager
def patched(replacements):
    """Set each (object, attribute, value) of `replacements` (a module or
    a class) for the duration of the block; on exit restore the old
    values, last first, and delete what a class only inherited."""
    saved = [(obj, name, vars(obj).get(name, _INHERITED))
             for obj, name, _ in replacements]
    try:
        for obj, name, value in replacements:
            setattr(obj, name, value)
        yield
    finally:
        for obj, name, value in reversed(saved):
            if value is _INHERITED:
                delattr(obj, name)
            else:
                setattr(obj, name, value)


@contextlib.contextmanager
def kernel_spans():
    """CUDA events around every kernel launch made inside, on the stream
    of the launch's card: the launchers are wrapped for the duration, and
    so is ShardGroup.map, to tag each launch with the shard that made it.
    Yields {(kernel, band W, shard): [(start, end), ...]}, shard None
    outside a shard group, W 0 for the extension prep (K3)."""
    import torch

    from bella_tpu_torch.align import pallas_xdrop as P
    from bella_tpu_torch.align import xdrop as X
    from bella_tpu_torch.parallel.sharded import ShardGroup

    orig, orig_prep, orig_map = P.launch_streams, X.launch_prep, ShardGroup.map
    spans: dict = {}
    lock = threading.Lock()  # shards on distinct cards launch at once
    here = threading.local()  # the shard the calling thread runs

    def span(device, name, W, launch):
        stream = torch.cuda.current_stream(device)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record(stream)
        out = launch()
        b.record(stream)
        key = (name, int(W), getattr(here, "shard", None))
        with lock:
            spans.setdefault(key, []).append((a, b))
        return out

    def timed(ts, qs, xdrop, W, cap, adaptive, with_steps=False,
              long_key=False):
        return span(ts.at.device,
                    "xdrop_adaptive" if adaptive else "xdrop_static", W,
                    lambda: orig(ts, qs, xdrop, W, cap, adaptive, with_steps,
                                 long_key))

    def timed_prep(rd, blk, k, L):
        return span(blk.device, "ext_prep", 0,
                    lambda: orig_prep(rd, blk, k, L))

    def tagged_map(group, fn, *per_shard):
        def run(dev, shard, *args):
            here.shard = shard
            try:
                return fn(dev, *args)
            finally:
                here.shard = None
        return orig_map(group, run, group.shards, *per_shard)

    with patched([(P, "launch_streams", timed), (X, "launch_prep", timed_prep),
                  (ShardGroup, "map", tagged_map)]):
        yield spans


def span_ms(spans) -> float:
    """Total ms of (start, end) CUDA event pairs (after a synchronize)."""
    return sum(a.elapsed_time(b) for a, b in spans)


@contextlib.contextmanager
def op_spans(ops=(), captured=()):
    """CUDA events around every call of `ops`, (module, function, label or
    a function of the call's arguments giving one), made inside, and the
    return values of `captured`, (module, function). Yields ({label:
    [(start, end), ...]}, {function: [result, ...]})."""
    import torch

    spans: dict = {}
    results: dict = {}

    def timed(fn, label):
        def wrapper(*a, **k):
            name = label(*a, **k) if callable(label) else label
            b0 = torch.cuda.Event(enable_timing=True)
            b1 = torch.cuda.Event(enable_timing=True)
            b0.record()
            out = fn(*a, **k)
            b1.record()
            spans.setdefault(name, []).append((b0, b1))
            return out
        return wrapper

    def kept(fn, name):
        def wrapper(*a, **k):
            out = fn(*a, **k)
            results.setdefault(name, []).append(out)
            return out
        return wrapper

    swaps = []
    for mod, name, label in ops:
        m = importlib.import_module(mod)
        swaps.append((m, name, timed(getattr(m, name), label)))
    for mod, name in captured:
        m = importlib.import_module(mod)
        swaps.append((m, name, kept(getattr(m, name), name)))
    with patched(swaps):
        yield spans, results
