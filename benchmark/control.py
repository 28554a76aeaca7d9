#!/usr/bin/env python3
"""The check's control: the plain reference put in the program's place at
a lower precision than the configuration states, read by the numbers the
check compares. It shows that the check fails such a program.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]
        [--device cuda|cpu]

The configuration states 64-bit k-mer words and 32-bit scores. Two
controls, on each seed's corpus and the check's own samples:

  * k-mer codes held in 32-bit words (the low 32 bits of each 34-bit
    canonical code at k = 17): read by detect_pairs_differing;
  * scores held in 16-bit lanes (saturating at 32,767, the narrower lanes
    of a two-cells-a-word kernel): read by align_pairs_differing, the
    sampled pairs whose full score does not fit (drawn uniformly: the
    control gives no alignments of its own to draw by level).

One JSON line a seed, with `correct` as the check's verdict
(check.verdict) gives it on those numbers and their limits: a control
that the check does not fail reads true. The benchmark's runs do not
run it.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
INT16_MAX = (1 << 15) - 1


def readings(cell, seed: int, device, workers: int) -> dict:
    import numpy as np

    from benchmark import check
    from benchmark.reference import detect as R
    from benchmark.reference import xdrop as X
    from benchmark.run import make_corpus

    t0 = time.perf_counter()
    flags = cell.config["flags"]
    sample = cell.traffic["check"]
    corpus = make_corpus(cell.traffic, seed)
    mask, rng = check.draw(seed, corpus.num_reads, sample["sample_reads"])
    ref = R.detect_sample(corpus.codes, corpus.offsets, mask, flags, device)
    ctl = R.detect_sample(corpus.codes, corpus.offsets, mask, flags, device,
                          key_bits=32)
    detect_bad = check.detect_differing(ctl.table(), mask, ref)
    sub, _ = check.pick_pairs(ref, np.zeros(len(ref), np.int64),
                              sample["sample_pairs"], 0, rng)
    ra = X.align_pairs(corpus.codes, corpus.offsets, sub, flags, workers)
    narrow = np.minimum(ra[:, 0], INT16_MAX)
    values = dict(detect_pairs_differing=detect_bad,
                  align_pairs_differing=int((narrow != ra[:, 0]).sum()))
    compared = [(k, v, check.LIMITS[k]) for k, v in values.items()]
    return dict(workload=cell.name, seed=seed,
                correct=check.verdict(compared), **values,
                reference_pairs=len(ref), control_pairs=len(ctl),
                sampled_pairs=len(sub), max_score=int(ra[:, 0].max()),
                seconds=time.perf_counter() - t0)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from benchmark import cells

    cell = cells.load(args.workload, ROOT)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("control.py: no CUDA card (--device cpu runs on the CPU)",
              file=sys.stderr)
        return 2
    workers = min(8, os.cpu_count() or 1)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, torch.device(args.device),
                                  workers)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
