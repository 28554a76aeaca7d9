#!/usr/bin/env python3
"""Split the port's alignment phase into its parts on the card (the
counterpart of scripts/align_profile.py).

  python3 scripts/torch_align_profile.py [--corpus bench|D]
      [--backend static|jax]

On bench.py's corpus (its sizes from the BELLA_BENCH_* variables, as
bench_torch.py), or dataset D, after detect_overlaps and one warm-up of
align_candidates (a split run, 2 below, whose count of cuts sizes the
CUDA events made before each later split run), steady runs of
align_candidates (1 and 2 in turns, three times each, or more, up to
15, till the plain runs add up to 4 s: a short phase's median needs more
samples; each timed run starts after a garbage collection, with the
collector off till it ends; the split run of median clock is reported,
and the two medians are set side by side):

  1. plain: the host clock around it, the phase as users run it;
  2. split: the functions of bella_tpu_torch.align.xdrop and pallas_xdrop
     wrapped from here (bella_tpu_torch.utils.measure.patched; the
     package has no switch for it), and the run's timelines cut at every
     entry to and exit from one of them (Split): each stretch goes to the
     innermost part open over it, on the card's timeline (CUDA events
     recorded at the cuts, so the card's work goes to the part that
     enqueued it) and on the host's. Nothing is synchronised that the
     run does not synchronise itself. The parts: the reads' upload;
     the pair block's upload (_pair_block, one a launch); extension prep
     (extension_streams: the streams' descriptors); K1 and K2
     (run_streams, with the plain versions' per-base gathers and packing
     on the CPU; their kernels also with CUDA events around the launch);
     _combine_extensions; each pass's batch loop (_extend_pairs: pair
     columns, the launch inputs, the results' scatter): the first pass,
     the cascade rounds, the adaptive pass, the tail; _predict_due; the
     cascade's bookkeeping (_align_share); the adaptive tail
     (_adaptive_tail_rescue); the host syncs (int(), bool(), item(),
     tolist(), and copies between host and card, of a CUDA tensor; by
     direction, counted by caller, with the host's seconds in them: its
     wait for the card and the copy, which the card's timeline shows
     alone); and the remainder, align_candidates
     outside every part. Each timeline adds up to the run; the card's is
     held to its run's host clock and to the plain runs' median, each
     within 5 %;
  3. traced: torch.profiler over the run, its top 15
     ops by device time and the card's busy share over the run (the union
     of its kernels', copies' and sets' intervals, by kineto's activity
     type, over the run's span; the run's own range is not work); if the
     trace shows no device time, a line says so and the split stands.

Also the extension lengths' percentiles (end - beg over both reads of a
pair, as align_profile.py). The last line is one JSON object. The card is
required; --device cpu runs the plain versions, for the tests.
"""

import argparse
import contextlib
import gc
import json
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

TOP_OPS = 15
RUNS = 3  # plain and split runs at least, in turns; medians compared
MIN_SECONDS = 4.0  # and more, up to MAX_RUNS, till the plain runs take this
MAX_RUNS = 15
SYNCING = ("__int__", "__bool__", "__float__", "item", "tolist", "cpu",
           "to")


class Split:
    """The host's and the card's timelines of one run, cut at every entry
    to and exit from a part: each stretch between two cuts is charged to
    the innermost part open over it ("remainder" where none is), on the
    host clock and, on the card, between CUDA events recorded at the cuts
    on the current stream. Nothing synchronises but the host syncs the
    run makes itself, which are parts of their own and are counted by
    caller, with the host's seconds in them. Each timeline adds
    up to the run: the host's to its clock, the card's to the span from
    its first event to its last."""

    def __init__(self, dev, events: int = 0):
        self.cuda = dev.type == "cuda"
        self.stack: list = []   # the parts open now, outermost first
        self.cuts: list = []    # (host time, event or None, open parts)
        self.syncs: dict = {}   # caller -> host syncs
        self.sync_s = {"D2H": 0.0, "H2D": 0.0}  # host seconds in syncs
        self.pool: list = []    # events made before the run, for its cuts
        if self.cuda:
            import torch

            # the package enqueues on the current stream only; a cut
            # records on it without looking it up, and takes an event
            # made (and recorded once) here, so the run pays neither
            self.stream = torch.cuda.current_stream(dev)
            self.event = lambda: torch.cuda.Event(enable_timing=True)
            self.pool = [self.event() for _ in range(events)]
            for ev in self.pool:
                ev.record(self.stream)
            torch.cuda.synchronize(dev)

    def cut(self) -> None:
        ev = None
        if self.cuda:
            ev = self.pool.pop() if self.pool else self.event()
            ev.record(self.stream)
        self.cuts.append((time.perf_counter(), ev, tuple(self.stack)))

    def run(self, label: str, fn, *a, **k):
        self.stack.append(label)
        self.cut()
        try:
            return fn(*a, **k)
        finally:
            self.stack.pop()
            self.cut()

    def wrap(self, fn, label):
        """fn wrapped as a part; label a string or a function of
        (split, args, kwargs) giving one."""
        def wrapper(*a, **k):
            name = label(self, a, k) if callable(label) else label
            return self.run(name, fn, *a, **k)
        return wrapper

    def timelines(self) -> tuple:
        """({part: host s}, {part: card s or None}, {part: inclusive host
        s}) over the cuts so far (after a synchronise)."""
        host, card, incl = {}, {}, {}
        for (h0, e0, open_), (h1, e1, _) in zip(self.cuts, self.cuts[1:]):
            label = open_[-1] if open_ else "remainder"
            host[label] = host.get(label, 0.0) + h1 - h0
            if self.cuda:
                card[label] = card.get(label, 0.0) + e0.elapsed_time(e1) / 1e3
            for part in set(open_):
                incl[part] = incl.get(part, 0.0) + h1 - h0
        return host, (card if self.cuda else None), incl


def _moves(t, a, k) -> str:
    """"D2H", "H2D" or "" for Tensor.to(*a, **k) on t."""
    import torch

    target = k.get("device")
    for x in a:
        if isinstance(x, (torch.device, str)):
            target = x
        elif isinstance(x, torch.Tensor):
            target = x.device
    if target is None:
        return ""
    kind = torch.device(target).type
    if t.device.type == "cuda" and kind == "cpu":
        return "D2H"
    if t.device.type == "cpu" and kind == "cuda":
        return "H2D"
    return ""


def sync_patches(split: Split) -> list:
    """Replacements for the torch.Tensor methods that wait for the card:
    on a CUDA tensor (or a host tensor copied to the card) each call is a
    part, "host sync: D2H" or "host sync: H2D", counted by its caller,
    with the host's seconds in it (the wait for the card and the copy
    together: a synchronize of its own before the call would add a round
    trip to the card at every sync, several a batch)."""
    import torch

    def wrapped(name, orig):
        def call(t, *a, **k):
            kind = _moves(t, a, k) if name == "to" else (
                "D2H" if t.device.type == "cuda" else "")
            if not kind:
                return orig(t, *a, **k)
            caller = sys._getframe(1).f_code.co_name
            split.syncs[caller] = split.syncs.get(caller, 0) + 1
            t0 = time.perf_counter()
            try:
                return split.run(f"host sync: {kind}", orig, t, *a, **k)
            finally:
                split.sync_s[kind] += time.perf_counter() - t0
        return call

    return [(torch.Tensor, n, wrapped(n, getattr(torch.Tensor, n)))
            for n in SYNCING]


def _pass_of(split: Split, a, k) -> str:
    """The batch loop's part: _extend_pairs(rd, pairs, sel, pair_len,
    xdrop, k, band, max_steps, adaptive, batch_size)."""
    adaptive = a[8] if len(a) > 8 else k["adaptive"]
    if "adaptive tail" in split.stack:
        return "batch loop: tail"
    if adaptive:
        return "batch loop: adaptive pass"
    band = a[6] if len(a) > 6 else k["band"]
    return ("batch loop: first pass" if band == split.first_band
            else "batch loop: cascade rounds")


def part_patches(split: Split, config) -> list:
    """Replacements that make the alignment loop's functions parts."""
    from bella_tpu_torch.align import pallas_xdrop as P
    from bella_tpu_torch.align import xdrop as X

    split.first_band = int(config.pallas_band)

    def kernel(s, a, k):
        adaptive = a[5] if len(a) > 5 else k["adaptive"]
        return "K2" if adaptive else "K1"

    run = split.wrap(P.run_streams, kernel)
    parts = [
        (X, "_upload_reads", "reads upload"),
        (X, "_pair_block", "prep: pair block upload"),
        (X, "extension_streams", "extension prep"),
        (X, "_combine_extensions", "combine"),
        (X, "_extend_pairs", _pass_of),
        (X, "_predict_due", "cascade: _predict_due"),
        (X, "_adaptive_tail_rescue", "adaptive tail"),
        (X, "_align_share", "cascade bookkeeping"),
        (X, "_align_check", "selfcheck"),
    ]
    return [(P, "run_streams", run), (X, "run_streams", run)] + [
        (m, name, split.wrap(getattr(m, name), label))
        for m, name, label in parts]


def _align(reads, pairs, config, dev):
    from bella_tpu_torch.align.xdrop import align_candidates

    return align_candidates(None, reads.lengths.astype(np.int32), pairs,
                            config, reads=reads, device=dev)


def split_run(reads, pairs, config, dev, events: int = 0):
    """One align_candidates run split into parts, with `events` CUDA
    events made before it for its cuts. Returns (the alignment, the run's
    host clock, the Split, K1/K2 ms from CUDA events around their
    launches)."""
    import torch

    from bella_tpu_torch.utils.measure import kernel_spans, patched, span_ms

    split = Split(dev, events)
    spans = {}
    with contextlib.ExitStack() as stack:
        stack.enter_context(patched(sync_patches(split)
                                    + part_patches(split, config)))
        if dev.type == "cuda":
            spans = stack.enter_context(kernel_spans())
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        split.cut()
        aln = _align(reads, pairs, config, dev)
        split.cut()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    total = time.perf_counter() - t0
    kernel_ms = {}
    for (name, _, _), v in spans.items():
        kernel_ms[name] = kernel_ms.get(name, 0.0) + span_ms(v)
    return aln, total, split, kernel_ms


# kineto's activity types of the card's own work; its other device events
# (gpu_user_annotation: a record_function range mirrored on the card's
# timeline) last as long as the range, not the work under it
DEVICE_WORK = ("kernel", "gpu_memcpy", "gpu_memset")


def is_device_work(e, window: str) -> bool:
    """Whether profiler event e is a kernel, copy or set on the card. Where
    the event has no activity type (an older torch), every device event
    but a user annotation and the window's own range."""
    if not str(getattr(e, "device_type", "")).endswith("CUDA"):
        return False
    kind = getattr(e, "activity_type", None)
    if kind:
        return str(kind) in DEVICE_WORK
    return not getattr(e, "is_user_annotation", False) and e.name != window


def device_busy(events, window: str) -> dict:
    """The card's busy share over the window: the union of the intervals
    of its kernels, copies and sets, cut to the span of the host events
    named `window`."""
    span = [e.time_range for e in events if e.name == window
            and not str(getattr(e, "device_type", "")).endswith("CUDA")]
    w0 = min(t.start for t in span)
    w1 = max(t.end for t in span)
    iv = sorted((max(e.time_range.start, w0), min(e.time_range.end, w1))
                for e in events if is_device_work(e, window))
    iv = [(s, e) for s, e in iv if e > s]
    busy, cur = 0.0, None
    for s, e in iv:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
    if cur is not None:
        busy += cur[1] - cur[0]
    return dict(window_s=(w1 - w0) / 1e6, device_busy_s=busy / 1e6,
                device_busy_share=busy / max(w1 - w0, 1e-9),
                device_intervals=len(iv))


def top_ops(averages, window: str, n: int = TOP_OPS) -> list:
    """The n ops of most device time, user annotations left out."""
    ops = []
    for avg in averages:
        if getattr(avg, "is_user_annotation", False) or avg.key == window:
            continue
        dt = getattr(avg, "self_device_time_total",
                     getattr(avg, "self_cuda_time_total", 0.0))
        ops.append(dict(name=avg.key, calls=avg.count, self_device_us=dt,
                        self_cpu_us=avg.self_cpu_time_total))
    ops.sort(key=lambda o: -o["self_device_us"])
    return ops[:n]


def trace_run(reads, pairs, config, dev) -> dict:
    """One run under torch.profiler: the top ops by device time and the
    card's busy share over the run."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
    window = "align_candidates"
    with profile(activities=acts) as prof:
        with record_function(window):
            _align(reads, pairs, config, dev)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return device_busy(prof.events(), window) | dict(
        top_ops=top_ops(prof.key_averages(), window))


@contextlib.contextmanager
def no_gc():
    """A collection now, and none till the block ends: a collection inside
    a timed run would add its pause to one run of the two kinds only."""
    gc.collect()
    gc.disable()
    try:
        yield
    finally:
        gc.enable()


def ext_percentiles(aln) -> dict:
    ext = (aln.end_h - aln.beg_h) + (aln.end_v - aln.beg_v)
    if not len(ext):
        return {}
    return {f"p{q}": float(np.percentile(ext, q)) for q in (50, 90, 99)} | {
        "max": int(ext.max()), "mean": float(ext.mean())}


def same_alignment(a, b) -> bool:
    fields = ("score", "beg_h", "end_h", "beg_v", "end_v", "strand_rc")
    return (all(np.array_equal(getattr(a, f), getattr(b, f)) for f in fields)
            and list(a.rescue_levels) == list(b.rescue_levels)
            and np.array_equal(a.tail_pairs, b.tail_pairs))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--corpus", choices=("bench", "D"), default="bench")
    ap.add_argument("--backend", choices=("static", "jax"), default="static")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    import bench_torch
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.overlap.pairs import detect_overlaps
    from bella_tpu_torch.utils.log import set_enabled
    from bella_tpu_torch.utils.measure import device_info

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_align_profile: no CUDA device", file=sys.stderr)
        return 2
    set_enabled(False)
    config = BellaConfig(aligner_backend=bench_torch.BACKENDS[args.backend])
    if args.corpus == "D":
        reads = bench_torch.demo_corpus()[1]
    else:
        reads = bench_torch.bench_corpus(**bench_torch.bench_sizes())
    pairs, _, nnz = detect_overlaps(reads, config, device=dev)
    clock = bench_torch.clock
    # the warm-up is a split run: its cuts size the later runs' events
    _, warm, split, _ = split_run(reads, pairs, config, dev)
    events = len(split.cuts) + 1024
    plain_runs, splits = [], []
    while len(plain_runs) < RUNS or (sum(plain_runs) < MIN_SECONDS
                                     and len(plain_runs) < MAX_RUNS):
        # in turns, plain then split
        with no_gc():
            t0 = clock(dev)
            plain = _align(reads, pairs, config, dev)
            plain_runs.append(clock(dev) - t0)
        with no_gc():
            aln, total, split, kernel_ms = split_run(reads, pairs, config,
                                                     dev, events)
        splits.append((total, aln, split.timelines(), split, kernel_ms))
    plain_s = float(np.median(plain_runs))
    splits.sort(key=lambda x: x[0])
    total, aln, (host, card, incl), split, kernel_ms = splits[len(splits) // 2]
    parts = card if card is not None else host
    parts_sum = sum(parts.values())
    row = dict(
        corpus=args.corpus, backend=args.backend, device=device_info(dev),
        reads=reads.num_reads, nnzA=int(nnz), pairs=int(pairs.num_pairs),
        aligned_bases=bench_torch.aligned_bases(aln),
        cascade=[list(x) for x in aln.rescue_levels],
        tail_pairs=int(len(aln.tail_pairs)),
        warmup_s=warm, plain_s=plain_s, plain_samples=plain_runs,
        split_s=total, split_samples=[x[0] for x in splits],
        timeline="card" if card is not None else "host",
        parts_s=parts, parts_sum_s=parts_sum,
        parts_share={k: v / parts_sum for k, v in parts.items()},
        host_parts_s=host, inclusive_host_s=incl,
        within_5pct=dict(split_run=abs(parts_sum - total) <= 0.05 * total,
                         plain_run=abs(parts_sum - plain_s) <= 0.05 * plain_s),
        host_syncs=sum(split.syncs.values()), host_syncs_by_caller=split.syncs,
        host_sync_s=split.sync_s,
        kernel_event_ms=kernel_ms,
        extension_length=ext_percentiles(aln),
        same_as_plain=same_alignment(aln, plain),
    )
    for k, v in sorted(parts.items(), key=lambda kv: -kv[1]):
        print(f"{k}: {v:.4f} s ({100 * v / parts_sum:.1f} %) on the "
              f"{row['timeline']}'s timeline, host {host.get(k, 0.0):.4f} s",
              file=sys.stderr)
    row["trace"] = trace_run(reads, pairs, config, dev)
    if not row["trace"]["device_intervals"]:
        print("trace: torch.profiler shows no device time; the split above "
              "(CUDA events) stands")
    for op in row["trace"]["top_ops"]:
        print(f"trace op {op['name']}: {op['calls']} calls, "
              f"{op['self_device_us'] / 1e3:.3f} ms on the device",
              file=sys.stderr)
    print(json.dumps(row))
    if not row["same_as_plain"] or not all(row["within_5pct"].values()):
        print("torch_align_profile: the split run differs from the plain "
              "run, or its parts miss a clock by more than 5 %",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
