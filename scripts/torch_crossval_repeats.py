#!/usr/bin/env python3
"""Repeat-rich accuracy cross-check of the port on the card (the
counterpart of scripts/crossval_repeats.py).

  python3 scripts/torch_crossval_repeats.py [workdir] [--backend static|jax]
      [--device cpu] [--genome N --reads N]

Reads from different repeat copies share k-mers and may even align
without a true genomic overlap: there the chaining and binning vote
decides the seed. The corpus is crossval_repeats.py's: a 60,000 bp
genome with ~25 % repeat content (random_genome_with_repeats, seed 81;
tandem and dispersed diverged copies) and 600 reads of mean 3,000 bp
(min 1,200, 15 % error, seed 82, circular=False). It runs through the
port's run_pipeline (M4 rows to <workdir>/rep_torch.out by the native
writer; --backend static, the default, takes the static-band path,
jax the adaptive one) and is scored with the port's eval against the
simulated truth at the 2 kb cutoff, with the run's wall and kernel
launches (on the card). The reference binary runs on the
same FASTQ only where .refbuild/bella exists, as in crossval_repeats.py.
The workdir keeps rep.fastq, rep.fofn and rep.truth, the inputs of
scripts/torch_run_pipeline.sh.

At the default sizes the candidate pairs and output rows are held to
REPEAT_ANCHORS; a miss exits 1. RC and PR are printed beside
bella_tpu's round-5 figures (README.md), which came from a TPU run of
older code: a comparison, not a target. The last line is one JSON
object. Without a workdir the files go to a temporary directory. The
card is required; --device cpu runs the kernels' plain versions, for
the tests (at smaller --genome and --reads).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

GENOME, READS = 60_000, 600
BACKENDS = {"static": "auto", "jax": "jax"}
# (candidate pairs, output rows) at the default sizes. jax: bella_tpu's
# run_pipeline with aligner_backend="jax" (its CPU default) on the JAX CPU
# backend (scripts/crossval_repeats.py: its log's candidatePairs and
# outputted). static: the port's first card run, on an NVIDIA H100
# (bella_tpu's static path needs the Pallas kernel, which on the CPU runs
# only in interpret mode); its rows are the adaptive path's in number and
# score the same RC and PR.
REPEAT_ANCHORS = {
    "jax": dict(pairs=18_902, rows=16_356),
    "static": dict(pairs=18_902, rows=16_356),
}
# bella_tpu's round-5 result on this corpus (README.md, BASELINE.md): a
# TPU run of older code, and the reference binary's
ROUND5 = dict(bella_tpu=dict(rc=94.53, pr=91.22),
              reference=dict(rc=94.55, pr=90.02))


def corpus(genome: int = GENOME, n_reads: int = READS):
    """crossval_repeats.py's (reads, truth)."""
    from bella_tpu_torch.io.simulate import (
        random_genome_with_repeats, sample_reads,
    )

    g = random_genome_with_repeats(genome, seed=81, repeat_frac=0.25)
    return sample_reads(g, n_reads, mean_len=3000, min_len=1200,
                        error_rate=0.15, seed=82, circular=False)


def score(out_path: str, truth_path: str) -> dict:
    """The port's eval of M4 rows at the 2 kb cutoff."""
    from bella_tpu_torch.eval.evaluate import (
        evaluate_sets, load_truth, parse_bella, truth_pairs,
    )

    m = evaluate_sets(parse_bella(out_path),
                      truth_pairs(load_truth(truth_path), 2000))
    return dict(rc=m.recall, pr=m.precision, f1=m.f1, truth=m.num_truth,
                output=m.num_output, true_positive=m.num_true_positive)


def run(workdir: str, backend: str, dev, genome: int, n_reads: int) -> dict:
    from bench_torch import clock
    from bella_tpu_torch.align import _build
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.simulate import write_fastq, write_truth
    from bella_tpu_torch.pipeline import run_pipeline
    from bella_tpu_torch.utils import log as ulog

    reads, truth = corpus(genome, n_reads)
    fq = os.path.join(workdir, "rep.fastq")
    truth_path = os.path.join(workdir, "rep.truth")
    fofn = os.path.join(workdir, "rep.fofn")
    write_fastq(fq, reads)
    write_truth(truth_path, truth)
    with open(fofn, "w") as f:
        f.write(fq + "\n")
    out = os.path.join(workdir, "rep_torch.out")
    ulog.reset()
    t0 = clock(dev)
    res = run_pipeline(reads, BellaConfig(aligner_backend=BACKENDS[backend]),
                       out, device=dev)
    wall = clock(dev) - t0
    with open(out) as f:
        rows = sum(1 for _ in f)
    row = dict(reads=reads.num_reads, bases=int(reads.lengths.sum()),
               nnzA=int(res.nnz), pairs=int(res.pairs.num_pairs), rows=rows,
               wall_s=wall, launches=_build.launches(),
               port=score(out, truth_path))
    refbin = os.path.join(ROOT, ".refbuild", "bella")
    if os.path.exists(refbin):
        subprocess.run([refbin, "-f", fofn, "-o",
                        os.path.join(workdir, "rep_ref"), "-k", "17", "-e",
                        "0.15"], check=True)
        row["reference"] = score(os.path.join(workdir, "rep_ref.out"),
                                 truth_path)
    else:
        print("reference binary missing (.refbuild/bella); skipping",
              file=sys.stderr)
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("workdir", nargs="?", default=None)
    ap.add_argument("--backend", choices=sorted(BACKENDS), default="static")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--genome", type=int, default=GENOME)
    ap.add_argument("--reads", type=int, default=READS)
    args = ap.parse_args(argv)

    import torch

    from bella_tpu_torch.utils.log import set_enabled
    from bella_tpu_torch.utils.measure import device_info

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("torch_crossval_repeats: no CUDA device", file=sys.stderr)
        return 2
    set_enabled(False)
    t0 = time.perf_counter()
    if args.workdir:
        os.makedirs(args.workdir, exist_ok=True)
        row = run(args.workdir, args.backend, dev, args.genome, args.reads)
    else:
        with tempfile.TemporaryDirectory() as work:
            row = run(work, args.backend, dev, args.genome, args.reads)
    want = (REPEAT_ANCHORS[args.backend]
            if (args.genome, args.reads) == (GENOME, READS) else None)
    missed = [] if want is None else [
        (k, row[k], v) for k, v in want.items() if row[k] != v]
    row.update(backend=args.backend, device=device_info(dev),
               genome=args.genome, seconds=time.perf_counter() - t0,
               round5=ROUND5,
               anchors=None if want is None else (
                   "missed" if missed else "held"))
    print(f"port ({args.backend}): RC {row['port']['rc']:.2f} PR "
          f"{row['port']['pr']:.2f}; bella_tpu round 5 (TPU, older code): "
          f"RC {ROUND5['bella_tpu']['rc']} PR {ROUND5['bella_tpu']['pr']}",
          file=sys.stderr)
    print(json.dumps(row))
    if missed:
        print(f"torch_crossval_repeats: anchors missed (key, got, want): "
              f"{missed}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
