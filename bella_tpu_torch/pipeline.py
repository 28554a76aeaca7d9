"""End-to-end overlap pipeline (counterpart of ``bella_tpu/pipeline.py``):
FASTQ ingest -> [--auto-bounds] -> detection (``detect_overlaps``, or the
modular branch for minimizer or syncmer selection, ``--split-count`` > 1,
the matrix dump and checkpoints: reliable triples, then
``generate_candidates``) -> [--selfcheck] -> x-drop alignment with the
rescue cascade -> Chernoff decision -> M4 / PAF / overlap-only rows (the
native writers when rows go to a file), optionally under
``torch.profiler`` (``--profile``).

With ``--devices N`` (config.devices > 1) or an explicit shard group,
detection runs distributed (``detect_overlaps_sharded``, or
``sharded_candidates`` on the modular branch) and alignment
data-parallel over the group; the rows are the single-device rows.
"""

from __future__ import annotations

import dataclasses
import os
from typing import List, Optional

import numpy as np

from bella_tpu_torch.align.xdrop import align_candidates
from bella_tpu_torch.config import BellaConfig, resolve_device
from bella_tpu_torch.io import matrixdump, writers
from bella_tpu_torch.io.fastq import ReadSet, read_files
from bella_tpu_torch.kmers.count import (
    build_reliable_triples, extract_occurrences,
)
from bella_tpu_torch.kmers.select import select_occurrences
from bella_tpu_torch.overlap.decision import post_align_decision
from bella_tpu_torch.overlap.pairs import (
    CandidatePairs, detect_overlaps, generate_candidates,
)
from bella_tpu_torch.parallel import (
    detect_overlaps_sharded, make_mesh, sharded_candidates,
)
from bella_tpu_torch.utils import selfcheck
from bella_tpu_torch.utils.log import PHASE_SECONDS, log, phase


@dataclasses.dataclass
class PipelineResult:
    reads: ReadSet
    num_kmers: int
    nnz: int
    pairs: CandidatePairs
    rows: List[str]
    num_output: int
    alignment: Optional[object] = None  # AlignmentResult when aligned


def shard_group(config: BellaConfig, dev, mesh=None):
    """The shard group a run uses: `mesh` when given, else for
    config.devices > 1 one shard a card on cuda:0 .. cuda:N-1 (raising
    when fewer cards are visible) or N shards on the CPU; else None."""
    if mesh is None and config.devices > 1:
        mesh = make_mesh(config.devices, dev)
    if mesh is not None:
        log("meshDevices", mesh.describe())
    return mesh


def _auto_bounds(reads: ReadSet, config: BellaConfig, dev) -> None:
    """--auto-bounds: [lower_freq, upper_freq] from the binomial model at
    --coverage, or at the depth estimated from the corpus's exact k-mer
    multiplicities."""
    from bella_tpu_torch.kmers.bound import (
        compute_lower, compute_upper, estimate_coverage,
    )

    cov = config.coverage
    if not cov:
        with phase("coverageEstimation"):
            cov = estimate_coverage(reads, config, device=dev)
        if cov <= 0:
            raise RuntimeError(
                "--auto-bounds: no usable multiplicity signal to "
                "estimate depth from; pass --coverage explicitly"
            )
        log("estimatedCoverage", cov)
    config.lower_freq = compute_lower(cov, config.error_rate,
                                      config.kmer_size, 0.002)
    config.upper_freq = compute_upper(cov, config.error_rate,
                                      config.kmer_size, 0.002)
    log("autoLowerBound", config.lower_freq)
    log("autoUpperBound", config.upper_freq)


def _collision_warning(reads: ReadSet, config: BellaConfig) -> None:
    """Warn when chance k-mer collisions become material: T positions in
    a 4^k space share a k-mer by chance ~T^2 / (2 4^k) times, and each
    fabricates a count-2 reliable k-mer."""
    total = int(reads.offsets[-1]) if reads.num_reads else 0
    expected = total * float(total) / (2.0 * 4.0 ** config.kmer_size)
    if expected > 0.02 * max(total, 1):
        log("kmerCollisionWarning",
            f"~{expected:.2e} chance k-mer collisions expected at "
            f"{total / 1e9:.2f} Gbp with k={config.kmer_size}; "
            "use a larger -k (e.g. 21+) or raise -l")


def _no_kmers(config: BellaConfig) -> RuntimeError:
    return RuntimeError(
        "0 reliable k-mers: all frequencies outside "
        f"[{config.lower_freq}, {config.upper_freq}]; reduce k or bounds"
    )


def _detect_fused(reads: ReadSet, config: BellaConfig, dev, mesh):
    """detect_overlaps (memory ladder included) or, over a shard group,
    detect_overlaps_sharded; then the self-check. Returns (pairs,
    num_kmers, nnz)."""
    with phase("overlapDetection"):
        if mesh is not None:
            pairs, num_kmers, nnz = detect_overlaps_sharded(reads, config,
                                                            mesh)
        else:
            pairs, num_kmers, nnz = detect_overlaps(reads, config,
                                                    device=dev)
    log("numReliableKmers", num_kmers)
    log("nnzA", nnz)
    log("candidatePairs", pairs.num_pairs)
    if pairs.num_pairs:
        log("compressionRatio",
            f"{nnz * (config.upper_freq - 1) / pairs.num_pairs:.2f}")
    if num_kmers == 0:
        raise _no_kmers(config)
    if config.selfcheck:
        with phase("selfCheck"):
            selfcheck.check_detection(reads, config, num_kmers, nnz)
            selfcheck.check_pairs(reads, pairs, config)
    return pairs, num_kmers, nnz


def _detect_modular(reads: ReadSet, config: BellaConfig, dev, mesh):
    """The modular branch (selection, split_count > 1, the matrix dump,
    checkpoints): reliable triples, resumed from the checkpoint when one
    exists, else counted in split-count passes over the selected
    occurrences (and saved); then generate_candidates and the self-check.
    Returns (pairs, num_kmers, nnz)."""
    tri = None
    if config.checkpoint:
        tri = matrixdump.load_checkpoint(config.checkpoint)
        if tri is not None:
            log("resumedFromCheckpoint", config.checkpoint)
    if tri is None:
        with phase("kmerCounting"):
            occ = extract_occurrences(reads, config, device=dev)
            occ = select_occurrences(occ, reads, config)
            tri = build_reliable_triples(reads, config, occ, device=dev)
            del occ
        if config.checkpoint:
            matrixdump.save_checkpoint(config.checkpoint, tri)
            log("checkpointSaved", config.checkpoint)
    if config.write_matrix:
        matrixdump.dump_matrix_market(config.write_matrix, tri)
        log("matrixDumped", config.write_matrix)
    log("numReliableKmers", tri.num_kmers)
    log("nnzA", tri.nnz)
    if tri.num_kmers == 0:
        raise _no_kmers(config)
    with phase("overlapDetection"):
        if mesh is not None:
            pairs = sharded_candidates(tri, reads.lengths, config, mesh)
        else:
            pairs = generate_candidates(tri, reads.lengths, config,
                                        device=dev)
    log("candidatePairs", pairs.num_pairs)
    if config.selfcheck:
        with phase("selfCheck"):
            if config.checkpoint is None:
                # split passes cover every k-mer, so the recount holds;
                # a resumed checkpoint's reads may differ
                selfcheck.check_detection(reads, config, tri.num_kmers,
                                          tri.nnz)
            selfcheck.check_pairs(reads, pairs, config)
    return pairs, tri.num_kmers, tri.nnz


def run_pipeline(reads: ReadSet, config: BellaConfig,
                 output: Optional[str] = None, device="cuda", mesh=None,
                 native: bool = True) -> PipelineResult:
    """Run the pipeline on `reads`; rows go to `output` when given,
    written by the native writers (native=False: the Python rows, which
    the result then holds). device defaults to "cuda" (raises without a
    card); "cpu" runs the kernels' plain versions. mesh: a ShardGroup to
    run over (make_mesh, or init_distributed's process group, where rank
    0 writes the output); without one, config.devices > 1 takes one
    shard a card (shard_group). With config.profile_dir the run is traced
    by torch.profiler into <profile_dir>/trace.json (Chrome format), with
    the port's bella.* spans (utils/log.py) beside the card's kernels."""
    dev = resolve_device(device)
    mesh = shard_group(config, dev, mesh)
    if mesh is not None:
        dev = mesh.devices[0]
    if not config.profile_dir:
        return _run(reads, config, output, dev, mesh, native)
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        result = _run(reads, config, output, dev, mesh, native)
    os.makedirs(config.profile_dir, exist_ok=True)
    path = os.path.join(config.profile_dir, "trace.json")
    prof.export_chrome_trace(path)
    log("profileTrace", path)
    return result


def _run(reads: ReadSet, config: BellaConfig, output: Optional[str],
         dev, mesh, native: bool) -> PipelineResult:
    if mesh is not None and mesh.rank != 0:
        output = None  # one rank writes
    if output is not None:
        log("outputFile", output)
    if config.estimate_err and reads.err_bases:
        config.error_rate = reads.estimated_error_rate
        log("errorRate (estimated)", f"{config.error_rate:.6f}")
    if reads.num_reads == 0:
        raise RuntimeError("no reads")
    if config.auto_bounds:
        _auto_bounds(reads, config, dev)
    _collision_warning(reads, config)

    fused = not (config.use_minimizer or config.use_syncmer
                 or config.split_count != 1
                 or config.write_matrix is not None
                 or config.checkpoint is not None)
    detect = _detect_fused if fused else _detect_modular
    pairs, num_kmers, nnz = detect(reads, config, dev, mesh)

    aln = None
    rows: List[str] = []
    to_file = output is not None and native
    if config.skip_alignment:
        with phase("outputting"):
            num_output = pairs.num_pairs
            if to_file:
                writers.write_overlap_native(output, reads, pairs)
            else:
                rows = writers.overlap_only_rows(pairs, reads)
    else:
        before = PHASE_SECONDS.get("alignment", 0.0)
        with phase("alignment"):
            aln = align_candidates(
                None, reads.lengths.astype(np.int32), pairs, config,
                reads=reads, device=dev, mesh=mesh,
            )
        dt_aln = PHASE_SECONDS["alignment"] - before
        if pairs.num_pairs and dt_aln > 0:
            aligned_bases = int(
                (aln.end_h - aln.beg_h).sum() + (aln.end_v - aln.beg_v).sum()
            )
            log("alignmentRate", f"{aligned_bases / dt_aln:.0f} bases/s")
        with phase("decision"):
            dec = post_align_decision(
                aln, pairs.read_h, pairs.read_v, reads.lengths, config
            )
            passed = dec["passed"]
        log("alignedPairs", pairs.num_pairs)
        log("outputted", int(passed.sum()))
        with phase("outputting"):
            idx = np.flatnonzero(passed)
            num_output = len(idx)
            cols = (pairs.read_h[idx], pairs.read_v[idx])
            aligned = (aln.score[idx], dec["overlap"][idx],
                       aln.strand_rc[idx], aln.beg_v[idx], aln.end_v[idx],
                       aln.beg_h[idx], aln.end_h[idx])
            if config.output_paf:
                if to_file:
                    writers.write_paf_native(output, reads, *cols, *aligned)
                else:
                    rows = writers.paf_rows(reads, *cols, *aligned)
            elif to_file:
                writers.write_m4_native(output, reads, *cols,
                                        pairs.count[idx], *aligned)
            else:
                rows = writers.m4_rows(reads, *cols, pairs.count[idx],
                                       *aligned)
    if output is not None and not native:
        writers.write_rows(output, rows)
    return PipelineResult(
        reads=reads, num_kmers=num_kmers, nnz=nnz, pairs=pairs, rows=rows,
        num_output=num_output, alignment=aln,
    )


def run_files(fofn: str, config: BellaConfig, output: str,
              device="cuda", mesh=None, native: bool = True
              ) -> PipelineResult:
    """Parse the fofn's (or one FASTQ's) reads, natively unless
    native=False, and run the pipeline on them."""
    with phase("fastqParsing"):
        reads = read_files(fofn, native=native)
    log("numReads", reads.num_reads)
    return run_pipeline(reads, config, output, device=device, mesh=mesh,
                        native=native)
