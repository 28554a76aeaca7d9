#!/usr/bin/env python3
"""A/B probe of the rescue cascade's drift predictor on the card (the
counterpart of scripts/rescue_predict_probe.py): align + decide with
config.rescue_predict on and off, on the same candidate pairs.

  python3 scripts/torch_rescue_predict_probe.py [--device cpu]

The corpus is bench.py's protocol at a 1.2 Mbp genome by default
(BELLA_BENCH_GENOME; BELLA_BENCH_COVERAGE and BELLA_BENCH_MEAN_LEN as in
bench_torch.py). Detection runs once; then, for the predictor on and
off, align_candidates + post_align_decision runs once to warm up and
BELLA_PROBE_REPS (3) times timed, every host clock reading after a
synchronise. The predictor routes an early-truncated saturated pair
straight to its predicted rescue band (align/xdrop.py:_predict_due);
a censored pair walks the doubling cascade either way.

Printed: each setting's median and samples, aligned bases, passed pairs,
cascade (band, pairs) and kernel launches a run (on the card), the ratio
off/on of the medians, and the pairs whose score differs between the
two (a cascade score is the maximum over the bands visited, so routing
can move it). At the bench
corpus' sizes (BELLA_BENCH_GENOME=300000) both settings must keep the
bench's pairs and the predictor-on run its aligned-base and passed
anchors (bench_torch.BENCH_ANCHORS["static"]); a miss exits 1. The last
line is one JSON object. The card is required; --device cpu runs the
kernels' plain versions, for the tests.
"""

import argparse
import json
import os
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GENOME = 1_200_000


def probe_sizes() -> dict:
    """bench_torch.bench_sizes() with this probe's default genome."""
    from bench_torch import bench_sizes

    sizes = bench_sizes()
    sizes["genome"] = int(os.environ.get("BELLA_BENCH_GENOME", GENOME))
    return sizes


def align_decide(reads, pairs, config, dev, reps: int):
    """align_candidates + post_align_decision: one warm-up, `reps` timed.
    Returns (alignment, decision, samples in s, the last run's kernel
    launches)."""
    from bench_torch import clock
    from bella_tpu_torch.align import _build
    from bella_tpu_torch.align.xdrop import align_candidates
    from bella_tpu_torch.overlap.decision import post_align_decision
    from bella_tpu_torch.utils import log as ulog

    lens = reads.lengths.astype(np.int32)
    dts = []
    for i in range(reps + 1):
        ulog.reset()
        t0 = clock(dev)
        aln = align_candidates(None, lens, pairs, config, reads=reads,
                               device=dev)
        dec = post_align_decision(aln, pairs.read_h, pairs.read_v,
                                  reads.lengths, config)
        if i:
            dts.append(clock(dev) - t0)
    return aln, dec, dts, _build.launches()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
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
        print("torch_rescue_predict_probe: no CUDA device", file=sys.stderr)
        return 2
    set_enabled(False)
    reps = int(os.environ.get("BELLA_PROBE_REPS", 3))
    sizes = probe_sizes()
    reads = bench_torch.bench_corpus(**sizes)
    config = BellaConfig()
    pairs, _, nnz = detect_overlaps(reads, config, device=dev)
    print(f"probe corpus: {reads.num_reads} reads, "
          f"{int(reads.lengths.sum())} bases; {pairs.num_pairs} pairs",
          file=sys.stderr)
    runs, alns = {}, {}
    for label, predict in (("on", True), ("off", False)):
        config.rescue_predict = predict
        aln, dec, dts, launches = align_decide(reads, pairs, config, dev,
                                               reps)
        bases = bench_torch.aligned_bases(aln)
        med = float(np.median(dts))
        alns[label] = aln
        runs[label] = dict(
            median_s=med, samples_s=dts, aligned_bases=bases,
            aligned_bases_per_s=bases / med, passed=int(dec["passed"].sum()),
            pairs=int(len(aln.score)),
            cascade=[list(x) for x in aln.rescue_levels],
            tail_pairs=int(len(aln.tail_pairs)), launches=launches)
        print(f"predict={label}: median {med:.3f} s, samples {dts}, "
              f"cascade {runs[label]['cascade']}", file=sys.stderr)
    differ = int((alns["on"].score != alns["off"].score).sum())
    anchors, missed = None, []
    if sizes == bench_torch.BENCH:
        want = bench_torch.BENCH_ANCHORS["static"]
        missed = [f"{label} pairs {r['pairs']}" for label, r in runs.items()
                  if r["pairs"] != want["pairs"]]
        missed += [f"on {k} {runs['on'][k]}" for k in ("aligned_bases",
                                                         "passed")
                   if runs["on"][k] != want[k]]
        anchors = "missed" if missed else "held"
    print(json.dumps(dict(
        device=device_info(dev), genome=sizes["genome"],
        bases=int(reads.lengths.sum()), nnzA=int(nnz),
        pairs=int(pairs.num_pairs), reps=reps, on=runs["on"],
        off=runs["off"],
        off_over_on=runs["off"]["median_s"] / runs["on"]["median_s"],
        scores_differ=differ, anchors=anchors)))
    if missed:
        print(f"torch_rescue_predict_probe: anchors missed: {missed}",
              file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
