#!/usr/bin/env python3
"""Run one cell of the benchmark once, on one card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

The cell is an entry of BENCHMARK.json's `workloads`: a configuration of
bella_tpu_torch (its flags) under a traffic mix (a corpus recipe);
benchmark/cells.py finds both, and the readers of the metrics, by name.

Set-up (timed as setup_s, from the start of this process): the port and
torch imported and the card initialised; the corpus made from --seed by
the benchmark's frozen generator and written as FASTQ under TMPDIR; one
warm-up pass, which loads the port's kernel and native libraries (built
into bella_tpu_torch/_build/ inside the checkout by the first run there).

The window: bella_tpu_torch.pipeline.run_files, the CLI's own call (the
native FASTQ parser and M4 writer, the rows to one file under TMPDIR), in
whole passes back to back until --seconds have passed; the pass that
crosses the limit is finished and counted. With --trace 1 the window
runs under torch.profiler, with a span around each call into a layer
(benchmark/tracing.py), and the per-layer metrics are reported; with
--trace 0 the end-to-end ones.

The run's record, from which each metric's reader takes its number,
holds the window's passes and clocks and the port's own phase seconds
and counters (bella_tpu_torch.utils.log's PHASE_SECONDS and COUNTS,
cleared as the window starts; counting is always on). Traced, it also
holds what the profile gives, read once after the window: the card's
busy time and the kernels inside the alignment spans (tracing.py), the
idle time split by the port's bella.* spans and each such span's host
seconds (program_spans.py).

Then the last pass's pairs, alignments and rows file are held to the
plain reference (benchmark/check.py), which decides `correct`. The last
line of standard output is one JSON object; the numbers compared, each
beside its limit, end standard error and the JSON line. Without a card,
or with fewer cards than the cell asks for, the run exits nonzero and
prints no result. It also does so if the process has loaded JAX or the
JAX package bella_tpu once the window has closed.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# top-level module names the run may not load (compared whole:
# bella_tpu_torch is the port, bella_tpu the JAX package)
FORBIDDEN = ("jax", "jaxlib", "flax", "bella_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def make_corpus(traffic: dict, seed: int):
    """The traffic mix's corpus at `seed` (the frozen generator)."""
    from benchmark.gen.simulate import random_genome, sample_reads

    g, r = traffic["genome"], traffic["reads"]
    genome = random_genome(g["length"], seed=seed + g["seed_offset"])
    return sample_reads(genome, r["count"], mean_len=r["mean_len"],
                        min_len=r["min_len"], error_rate=r["error_rate"],
                        seed=seed + r["seed_offset"], circular=r["circular"],
                        lengths=r.get("lengths"))


def _clock(dev) -> float:
    """The host clock, once the card has finished what was enqueued."""
    import torch

    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    return time.perf_counter()


def aligned_bases(aln) -> int:
    return int((aln.end_h - aln.beg_h).sum() + (aln.end_v - aln.beg_v).sum())


def _band(flags: dict) -> int:
    from benchmark.reference.xdrop import static_band

    if flags["aligner_backend"] in ("auto", "pallas"):
        return static_band(flags["pallas_band"])
    return int(flags["band_width"])


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             workers: int = 0, t_start: float = T_START) -> dict:
    """One run of `cell`: set-up, the window, the check. Returns the
    result object (the JSON line's content)."""
    import torch

    from benchmark import check, program_spans, tracing
    from benchmark.gen.simulate import write_fastq
    from bella_tpu_torch import pipeline
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.utils import log as plog

    plog.set_enabled(False)
    dev = torch.device(device)
    torch.zeros(1, device=dev)  # the card's context
    parts = [("imports and card init", time.perf_counter())]
    flags = cell.config["flags"]
    corpus = make_corpus(cell.traffic, seed)
    parts.append(("corpus made", time.perf_counter()))
    with tempfile.TemporaryDirectory(prefix="bella-bench-") as work:
        fastq = os.path.join(work, "reads.fastq")
        rows = os.path.join(work, "rows.m4")
        write_fastq(fastq, corpus)
        # on disk before the window, so that its write-back does not
        # fall inside it
        with open(fastq, "rb") as f:
            os.fsync(f.fileno())
        parts.append(("FASTQ written", time.perf_counter()))

        def one_pass():
            return pipeline.run_files(fastq, BellaConfig(**flags),
                                      output=rows, device=dev)

        one_pass()
        setup_s = _clock(dev) - t_start
        parts.append(("warm-up pass (libraries loaded or built)",
                      time.perf_counter()))
        marks = [t_start] + [t for _, t in parts]
        print("setup: " + ", ".join(f"{name} {b - a:.2f} s" for (name, b), a
                                    in zip(parts, marks)), file=sys.stderr)

        plog.PHASE_SECONDS.clear()
        counts = getattr(plog, "COUNTS", {})  # the port's counters, if any
        counts.clear()
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        prof = None
        with contextlib.ExitStack() as stack:
            if trace:
                from torch.profiler import (ProfilerActivity, profile,
                                            record_function)

                acts = [ProfilerActivity.CPU] + (
                    [ProfilerActivity.CUDA] if dev.type == "cuda" else [])
                prof = stack.enter_context(profile(activities=acts))
                stack.enter_context(record_function(tracing.WINDOW))
                stack.enter_context(tracing.layer_spans())
            passes = failed = 0
            res = None
            t0 = _clock(dev)
            while True:
                try:
                    res = one_pass()
                    passes += 1
                except Exception:  # a failed pass counts, the run goes on
                    failed += 1
                    traceback.print_exc()
                if _clock(dev) - t0 >= seconds:
                    break
            window_s = _clock(dev) - t0
        peak = (int(torch.cuda.max_memory_allocated(dev))
                if dev.type == "cuda" else None)
        record = dict(kind=(torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                      setup_s=setup_s, passes=passes, window_s=window_s,
                      corpus_bases=corpus.bases, peak_bytes=peak,
                      phase_s=dict(plog.PHASE_SECONDS), counts=dict(counts),
                      trace=None)
        breakdown = None
        if prof is not None:
            t1 = time.perf_counter()
            events = tracing.read(prof.profiler.kineto_results.events())
            del prof
            summary = tracing.summarise(events)
            split = program_spans.idle_split(events)
            per_pass = aligned_bases(res.alignment) if res else 0
            record["trace"] = dict(
                summary, aligned_bases=per_pass * passes,
                packed_bytes=corpus.bases // 4 * passes, band=_band(flags),
                idle_in_span=split["idle_in_span"],
                idle_by_innermost=split["idle_by_innermost"],
                span_s=program_spans.span_s(events))
            del events
            breakdown = dict(device_ops=summary["device_ops"],
                             idle_gaps=summary["idle_gaps"])
            top = sorted(split["idle_by_innermost"].items(),
                         key=lambda kv: -kv[1])[:5]
            print(f"trace read in {time.perf_counter() - t1:.1f} s; idle by "
                  "innermost span: " + ", ".join(f"{n} {v:.3f} s"
                                                 for n, v in top),
                  file=sys.stderr)

        compared, checked = [], {}
        if res is not None:
            if dev.type == "cuda":
                torch.cuda.empty_cache()
            t1 = time.perf_counter()
            compared, checked = check.compare(
                corpus, flags, seed, cell.traffic["check"], res.pairs,
                res.alignment, rows, dev,
                workers or min(8, os.cpu_count() or 1))
            print(f"check: {checked} in {time.perf_counter() - t1:.1f} s",
                  file=sys.stderr)
    correct = passes > 0 and failed == 0 and check.verdict(compared)
    metrics = {}
    for m in cell.metrics(trace):
        v = m.read(record)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    result = {
        "correct": correct,
        "attempted": passes + failed,
        "failed": failed,
        "metrics": metrics,
        "device": dict(
            platform="gpu" if dev.type == "cuda" else dev.type,
            kind=record["kind"], count=cell.chips if dev.type == "cuda"
            else 0, memory_peak_bytes=peak),
    }
    if record["trace"] is not None:
        t = record["trace"]
        result["device"].update(busy_s=t["busy_s"], window_s=t["window_s"])
        result["breakdown"] = breakdown
    result["checked"] = checked
    result["compared"] = {n: {"value": v, "limit": lim}
                          for n, v, lim in compared}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import cells

    cell = cells.load(args.workload, ROOT)
    import torch

    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell.chips):
        print(f"run.py: {args.workload} needs {cell.chips} CUDA card(s); "
              f"{torch.cuda.device_count()} visible", file=sys.stderr)
        return 2
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    found = forbidden_modules()
    if found:
        print(f"run.py: the process loaded {found}", file=sys.stderr)
        return 3
    for name, c in result["compared"].items():
        print(f"{name} {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
