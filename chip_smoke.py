"""Smoke run of bella_tpu_torch on one CUDA card (or several): builds the
port's kernels from bella_tpu_torch/align/csrc, holds each against its
plain PyTorch version, drives the main path (run_pipeline) on the bench
corpus, at E. coli 30X demo scale (also on the adaptive-band aligner
backend), on a yeast-sized corpus of more than 65,535 reads and on
ultra-long reads, runs the memory ladder, every single-device option at
demo scale and on a HiFi corpus, --devices over four shards and over two
processes, the general SpGEMM and the native ingest and writers, runs
each measurement tool (bench_torch.py and scripts/torch_*.py) once, and
prints a kernel table.

    python3 chip_smoke.py

(``chip_smoke.py --dist-worker RANK PORT OUT BACKEND`` is one rank of
phase 14, started by the script itself.)

Phases (any failure exits nonzero and prints no result):
  1. the card's name and power limit (nvidia-smi); the kernels' build
     (one nvcc a source, all at once), with registers and spills per
     instantiation
  2. K1 (static-band x-drop) and K2 (adaptive-band x-drop) against their
     plain versions, bit-exact with steps, at W = 128 .. 2048 (K1) and
     31 .. 1024 (K2): B = 1 and 13, the longest extension last, lengths
     near 65,535 (that plain version on the CPU, in a subprocess started
     with the script), binding step caps; K3 (extension prep) against its
     plain version on the card, torch.equal on every output, on seeded
     batches: forward and rc seeds, seeds at position 0 and len - k of
     read 0 and of the last read, lengths no multiple of 16, k = 17 and
     31, a read of 131,085 bases, 4B above the grid's 65,535 rows, a
     batch width beyond its reads
  3. long: K1 and K2 on two near-identical extensions just above 2^17
     bases a side (the long-key instantiation) against their plain
     versions, which run on the CPU in two more such subprocesses; the long-key instantiation against the int32 one at every W
     of phase 2; the wrappers take the int32 key below 2^17
  4. the whole path on a small corpus, card rows == CPU rows, at the
     default config, and on smaller ones in every mode of phases 11 and 12
     and on the adaptive-band backend (rows and scores)
  5. main path on the bench corpus (bench.py's: genome 300,000 seed 0;
     1,250 reads, mean 6,000 bp, 15 % error, seed 1) at the default
     config, with its recorded anchors, and its first pass as one
     descriptor-fed launch against K3 and K1 on its former batches of
     align_batch pairs (bit for bit, timed, tails modelled:
     level_against_batches); then the same corpus with the
     static cascade capped at 256 lanes, which sends the residue
     through K2 (the adaptive exactness tail)
  6. main path on dataset D of scripts/crossval_large.sh (genome 4.6 Mbp
     seed 401; 23,000 reads, mean 6 kbp, 15 % error, seed 402), with its
     anchors and K1's in-path time by band; its first pass as one launch
     against its former batches, as in 5
  7. adaptive: dataset D with aligner_backend="jax" (K2 at band_width on
     every pair, no cascade): D's detection anchors, its rows anchored,
     scored and set against the static path's; K2's launches, in-path
     time, and every extension again with steps (its time and bound); 256
     of D's pairs through K2 and its plain version on the card, bit for
     bit; the bench corpus over two shards equal to one device
  8. ladder: dataset D's detection at budgets that pick each rung beyond
     the single pass (fused split; the staged chain at both ends of its
     band: equal to the single pass field for field, peak within the
     budget; host-staged triples: equal but for the flip ties of the
     unpacked seed rule, counted); generate_candidates on D's triples at
     the edge of its packed gate (equal, within the budget) and of its
     unpacked one stage (within the budget); the bench corpus at
     split_count = 2 (the modular branch) against split_count 1
  9. wide: a yeast-sized corpus (genome 12.1 Mbp seed 501; 70,583 reads,
     mean 6 kbp, 15 % error, seed 502; 35X) on the main path through the
     wide-id branch, with its anchors; its detection again on the fused
     split path and on the staged chain at its gate, each equal field
     for field and within its budget
 10. ultralong: the unpacked branch end to end (genome 2 Mbp seed 601;
     1,333 reads, mean 30 kbp, min 5 kbp, 15 % error, seed 602; 20X), with
     its anchors
 11. modes: dataset D on the main path with -w 7, -s, --hopc,
     --auto-bounds (depth estimated), --selfcheck (the host recount equal
     to nnzA, K1 held against K2) and a checkpoint saved, then resumed
     without counting; each scored against D's truth through the port's
     eval, with the time of this slice's torch ops (HOPC at k = 31: see
     MODES); the minimizer and
     syncmer masks of D's first 2,000 reads against a numpy loop
 12. hifi: D's genome, 7,700 reads (10X, mean 6 kbp, 0.5 % error, seed
     403), under --auto-bounds: k = 31 with --selfcheck; k = 32, -e
     0.005, --split-count 2, --paf with --selfcheck; k = 32 --hopc, -e
     0.035 (the bounds at HOPC's error rate)
 13. multidev: four shards (one a card where four are visible, else four
     on cuda:0; each line names the group's devices): dataset D through
     the fused branch (detect_overlaps_sharded, data-parallel alignment)
     and with -w 7 through the modular one (sharded_candidates), each
     equal to its single-device run; the wide corpus's detection on four
     shards and the bench corpus's on two with the wide row layout forced,
     each equal to its single pass; K1 launches and ms by shard, exchange
     bytes and seconds, peak memory by card
 14. multiproc: two processes started with torchrun's variables,
     init_distributed and detect_overlaps_sharded on the bench corpus
     (NCCL, one card a rank, where two cards are visible; else gloo with
     both ranks on cuda:0), pairs equal to the single-device run's
 15. spgemm: C = A A for R-MAT scale 14, edge factor 8, seed 0, on the
     card, equal to scipy.sparse's product
 16. native: dataset D written as FASTQ, parsed natively (equal to the
     numpy parse), and run_files on it with the native M4 writer, whose
     rows equal the demo's Python rows byte for byte
 17. tools: each measurement tool in a subprocess on the bench corpus,
     as a user runs it (bench_torch.py on both backends,
     scripts/torch_align_profile.py, torch_align_bench.py --pairs 1024,
     torch_detect_profile.py, torch_weak_scaling.py at 1 and 2 shards),
     and the ported scripts: torch_rescue_predict_probe.py on the bench
     corpus (both settings keep its pairs, the predictor on its aligned
     bases and passed pairs), torch_crossval_repeats.py on both backends
     (pairs and rows anchored), torch_detect_recall_probe.py at the
     bench's genome (nnzA and pairs), torch_split_group_probe.py at its
     2 Mbp genome (parity with the single pass, both chains); each exits
     0 and its last line keeps its contract and anchors; then
     torch_run_pipeline.sh on the repeat corpus (its CSV row carries
     the static run's recall and precision)
 18. kernel table: time on the card against the plain version and the
     least time the card could take, at the main path's shapes (and the
     long-key instantiation at the long phase's), and the bench first
     pass as one launch (K2's row: dataset D on the adaptive backend, one
     launch; K3's: D's first pass in its former batches); launches on
     every main-path run, by shard on the multi-device runs

Every main-path run launches no K3 (K1 and K2 read the reads' words
through descriptors) and one x-drop launch a cascade level.

The last line is {"ok": true, "device": {...}}; the kernel table and the
card's name and power limit are on the lines before it.
"""

from __future__ import annotations

import contextlib
import heapq
import json
import os
import subprocess
import sys
import time
import traceback

import numpy as np

# H100 SXM peaks used for the bounds (NVIDIA data sheet, at 700 W)
HBM_BYTES_PER_S = 3.35e12
# no int32 row in the table: the 32-bit non-tensor peak (float32, 67 T/s)
# is an upper limit on the card's int32 rate, so the bound stays a bound
OPS_PER_S = 67e12
OPS_PER_CELL = 5  # compare, two adds, two max per band cell
# K3: funnel shift, bit reversal and pair swap (4), complement, mask
PREP_OPS_PER_WORD = 8

BENCH_ANCHORS = dict(nnz=602_440, pairs=29_948, aligned=195_798_404,
                     passed=27_694,
                     levels=((256, 1478), (512, 546), (1024, 109), (2048, 4)))
# dataset D: nnzA, pairs and rows as recorded for bella_tpu (BASELINE.md);
# the cascade and the tail as the port's first card runs gave them
DEMO_ANCHORS = dict(nnz=13_996_132, pairs=1_434_878, rows=619_273,
                    levels=((256, 392_340), (512, 207_623), (1024, 42_376),
                            (2048, 2_377)),
                    tail_pairs=1)
# the wide and ultralong corpora: as the port's first card run gave them
WIDE_ANCHORS = dict(nnz=56_775_844, pairs=9_910_571, rows=2_214_673,
                    levels=((256, 3_619_309), (512, 1_958_641),
                            (1024, 404_275), (2048, 22_673)),
                    tail_pairs=7)
ULTRALONG_ANCHORS = dict(nnz=3_069_277, pairs=88_663, rows=26_017,
                         levels=((256, 24_573), (512, 25_131),
                                 (1024, 16_655), (2048, 5_718)),
                         tail_pairs=168)
# dataset D with aligner_backend="jax": as the port's first card run gave
# them (the detection anchors are the demo's); bella_tpu's adaptive path
# gives the port's aligned bases and passed pairs on the bench corpus
# (scripts/reference_anchors.py), but not D within 40 minutes on a CPU
ADAPTIVE_ANCHORS = dict(nnz=13_996_132, pairs=1_434_878, rows=619_271,
                        levels=[], tail_pairs=0)
ADAPTIVE_SAMPLE = 256  # D's pairs held bit for bit against K2's plain version
# the bench first pass's longest pairs, and others drawn at random, held
# bit for bit against K1's plain version as the main path launches K1
K1_LONGEST, K1_SAMPLE = 8, 120
# dataset D's pairs whose host-staged-triples seed (the unpacked branch's
# rule, bella_tpu's too) differs from the single pass's by a flip tie
DEMO_FLIP_TIES = 1
# the modes phase on dataset D and the hifi phase: (label, config)
MODES = (
    ("demo -w 7", dict(window_len=7)),
    ("demo -s", dict(use_syncmer=True)),
    # HOPC at k = 17 pairs nearly every read with every other on a
    # 15 %-error corpus (chance collisions of compressed 17-mers, as in
    # bella_tpu): at 30X on 0.6 Mbp, 25 x the plain run's pairs at k = 25
    ("demo --hopc -k 31", dict(use_hopc=True, kmer_size=31)),
    ("demo --auto-bounds", dict(auto_bounds=True)),
    ("demo --selfcheck", dict(selfcheck=True)),
)
HIFI_MODES = (
    ("hifi k=31 --selfcheck",
     dict(kmer_size=31, auto_bounds=True, selfcheck=True)),
    ("hifi k=32 -e 0.005 --split-count 2 --paf --selfcheck",
     dict(kmer_size=32, error_rate=0.005, split_count=2, output_paf=True,
          auto_bounds=True, selfcheck=True)),
    ("hifi k=32 --hopc -e 0.035",
     dict(kmer_size=32, use_hopc=True, error_rate=0.035, auto_bounds=True)),
)
# as the port's first card run of each mode gave them; --selfcheck and
# the checkpoint runs give the demo's
MODE_ANCHORS = {
    "demo -w 7": dict(nnz=2_938_467, pairs=738_335, rows=553_534, levels=[
        [256, 96_362], [512, 47_108], [1024, 9_545], [2048, 542]],
        tail_pairs=0),
    "demo -s": dict(nnz=2_342_820, pairs=698_208, rows=526_074, levels=[
        [256, 89_866], [512, 43_920], [1024, 8_976], [2048, 500]],
        tail_pairs=0),
    "demo --hopc -k 31": dict(nnz=28_420_362, pairs=444_706, rows=16,
                              levels=[[256, 33_176], [512, 14_160],
                                      [1024, 2_890], [2048, 166]],
                              tail_pairs=0),
    "demo --auto-bounds": dict(nnz=13_736_499, pairs=1_424_026, rows=616_495,
                               levels=[[256, 388_422], [512, 205_530],
                                       [1024, 41_950], [2048, 2_351]],
                               tail_pairs=1),
    "hifi k=31 --selfcheck": dict(nnz=39_440_371, pairs=76_404, rows=76_404,
                                  levels=[], tail_pairs=0),
    "hifi k=32 -e 0.005 --split-count 2 --paf --selfcheck": dict(
        nnz=24_161_831, pairs=72_124, rows=72_124, levels=[], tail_pairs=0),
    "hifi k=32 --hopc -e 0.035": dict(nnz=34_413_339, pairs=77_292,
                                      rows=76_362, levels=[
                                          [256, 422], [512, 223], [1024, 41],
                                          [2048, 4]], tail_pairs=0),
}
for _label in ("demo --selfcheck", "demo --checkpoint (save)",
               "demo --checkpoint (resume)"):
    MODE_ANCHORS[_label] = dict(
        DEMO_ANCHORS, levels=[list(x) for x in DEMO_ANCHORS["levels"]])
LONG_BASES = (1 << 17) + 100  # a side of the long phase's extensions
LONG_XDROP = 25


def toolchain() -> dict:
    """Versions of what builds and runs the port on this machine."""
    import platform

    import torch

    from bella_tpu_torch.align import _build

    out = dict(python=platform.python_version(), torch=torch.__version__,
               torch_cuda=torch.version.cuda)
    try:
        r = subprocess.run([_build._nvcc(), "--version"], capture_output=True,
                           text=True, timeout=60)
        out["nvcc"] = r.stdout.strip().splitlines()[-1]
    except (RuntimeError, OSError, IndexError) as e:
        out["nvcc"] = f"unavailable: {e}"
    try:
        import triton

        out["triton"] = triton.__version__
    except ImportError:
        out["triton"] = None
    out["cutlass_headers"] = os.path.isfile(
        "/usr/local/cutlass/include/cutlass/cutlass.h")
    return out


def ptxas_summary() -> list:
    """Registers and spills of each kernel instantiation, from the build
    log nvcc -Xptxas -v wrote beside the library."""
    import re

    from bella_tpu_torch.align import _build

    log = _build.build("xdrop.cu").with_suffix(".log")
    out, fn = [], None
    for line in log.read_text().splitlines() if log.exists() else []:
        m = re.search(r"xdrop_kernelILb(\d)ELi(\d+)ELi(\d+)ELb(\d)E", line)
        if "Compiling entry function" in line and m:
            fn = (f"xdrop<adaptive={m.group(1)}, LPT={m.group(2)}, "
                  f"G={m.group(3)}, long_key={m.group(4)}>")
        elif "Compiling entry function" in line and "prep_kernel" in line:
            fn = "prep"
        elif fn and ("registers" in line or "spill" in line):
            out.append(f"{fn}: {line.split(':', 1)[-1].strip()}")
    return out


# the torch ops this slice added, timed on the main path: (module,
# function, label or a function of the call's arguments giving one)
SLICE_OPS = (
    ("bella_tpu_torch.overlap.pairs", "hopc_kmers", "hopc extraction"),
    ("bella_tpu_torch.overlap.pairs", "_sort_stream",
     lambda key, payload: "k-mer sort, two passes (k = 32)"
     if isinstance(key, tuple) else "k-mer sort, one word"),
    ("bella_tpu_torch.kmers.count", "_count_and_filter",
     "triples count sort (unsigned order)"),
    ("bella_tpu_torch.kmers.select", "minimizer_mask", "minimizer mask"),
    ("bella_tpu_torch.kmers.select", "syncmer_mask", "syncmer mask"),
    ("bella_tpu_torch.kmers.count", "multiplicity_stats",
     "multiplicity_stats"),
)
# results a run's checks return, kept for the report
CAPTURED = (
    ("bella_tpu_torch.utils.selfcheck", "host_reliable_stats"),
    ("bella_tpu_torch.align.xdrop", "_align_check"),
    ("bella_tpu_torch.kmers.bound", "estimate_coverage"),
)


def score_rows(rows, truth, paf: bool, workdir: str) -> dict:
    """Recall and precision of output rows against the simulator's truth
    (overlaps of 2,000 bp or more), through the port's evaluator."""
    from bella_tpu_torch import eval as E

    path = os.path.join(workdir, "rows.paf" if paf else "rows.m4")
    with open(path, "w") as f:
        f.writelines(rows)
    table: dict = {}
    for ref, name, start, end in truth:
        table.setdefault(ref, []).append((name, start, end))
    G = E.truth_pairs(table, 2000)
    S = (E.parse_paf if paf else E.parse_bella)(path)
    m = E.evaluate_sets(S, G)
    return dict(recall=m.recall, precision=m.precision)


def random_batch(rng, B: int, L: int):
    """Pairs at 15 % error with lengths 0..L, zero-length rows, and rows
    whose optimal path drifts one lane every e bases (past W/2 for every
    band tried)."""
    import torch

    T = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Q = np.zeros((B, L), np.uint8)
    tl = rng.integers(0, L + 1, B).astype(np.int32)
    ql = np.zeros(B, np.int32)
    for b in range(B):
        t = T[b, :tl[b]]
        kind = b % 4
        if kind == 0:
            q = t[np.arange(len(t)) % int(rng.choice([3, 4, 6])) != 0]
        else:
            r = rng.random(len(t))
            q = t.copy()
            sub = r < 0.05
            q[sub] = (q[sub] + 1) % 4
            q = q[~((r >= 0.05) & (r < 0.10))]  # deletions
            ins = np.flatnonzero((r >= 0.10) & (r < 0.15))
            ins = ins[ins < len(q)]
            q = np.insert(q, ins, rng.integers(0, 4, len(ins)).astype(np.uint8))
        q = q[:L]
        Q[b, :len(q)] = q
        ql[b] = len(q)
    tl[:2] = 0
    ql[0] = 0
    ql[2] = 0
    return [torch.from_numpy(x).cuda() for x in (T, tl, Q, ql)]


def pairs_of(rng, tlens):
    """Pairs at 15 % error (5 % substitutions, deletions, insertions)
    whose T sides have the given lengths, in that order, on the card."""
    import torch

    return [torch.from_numpy(x).cuda() for x in pairs_np(rng, tlens)]


def pairs_np(rng, tlens):
    """pairs_of's numpy arrays (T, t_len, Q, q_len)."""
    L = max(max(tlens), 1)
    T = np.zeros((len(tlens), L), np.uint8)
    Q = np.zeros((len(tlens), L), np.uint8)
    tl = np.asarray(tlens, np.int32)
    ql = np.zeros(len(tlens), np.int32)
    for b, n in enumerate(tlens):
        t = rng.integers(0, 4, n).astype(np.uint8)
        r = rng.random(n)
        q = t.copy()
        q[r < 0.05] = (q[r < 0.05] + 1) % 4
        q = q[~((r >= 0.05) & (r < 0.10))]
        ins = np.flatnonzero((r >= 0.10) & (r < 0.15))
        ins = ins[ins < len(q)]
        q = np.insert(q, ins, rng.integers(0, 4, len(ins)).astype(np.uint8))
        q = q[:L]
        T[b, :n] = t
        Q[b, :len(q)] = q
        ql[b] = len(q)
    return T, tl, Q, ql


def edge_batch():
    """Three pairs whose T sides have 65,535, 64,990 and 120 bases."""
    return pairs_np(np.random.default_rng(65_535), [65_535, 64_990, 120])


def same(a: dict, b: dict) -> int:
    """Max |a - b| over the outputs both hold (0 when bit-exact)."""
    import torch

    return max(int((a[k].to(torch.int64) - b[k].to(torch.int64)).abs().max())
               if a[k].numel() else 0
               for k in ("score", "t_end", "q_end", "steps") if k in a)


PREP_KEYS = ("T", "Q", "t_len", "q_len", "seed_end_h", "seed_end_v")


def prep_reads(rng, lens):
    """A ReadSet of random bases with these lengths."""
    from bella_tpu_torch.io.fastq import ReadSet

    lens = np.asarray(lens, np.int64)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(0, 4, int(offsets[-1])).astype(np.uint8)
    return ReadSet([f"r{i}" for i in range(len(lens))], codes, offsets)


def prep_pairs(rng, lens, n: int, k: int, must=()):
    """n seeded pairs between reads at least k long, forward and rc seeds
    at random positions, then for each read in `must` (read 0, the last
    read, a long one) seeds at position 0 and at len - k on H and on V,
    on both strands."""
    from types import SimpleNamespace

    lens = np.asarray(lens, np.int64)
    ok = np.flatnonzero(lens >= k)
    h, v = rng.choice(ok, n), rng.choice(ok, n)
    pos_h = (rng.random(n) * (lens[h] - k + 1)).astype(np.int64)
    pos_v = (rng.random(n) * (lens[v] - k + 1)).astype(np.int64)
    rc = rng.random(n) < 0.5
    eh, ev, eph, epv, erc = [], [], [], [], []
    for r in must:
        other = int(rng.choice(ok))
        for at in (0, int(lens[r]) - k):
            for strand in (False, True):
                eh += [r, other]
                ev += [other, r]
                eph += [at, int(rng.integers(0, lens[other] - k + 1))]
                epv += [int(rng.integers(0, lens[other] - k + 1)), at]
                erc += [strand, strand]
    return SimpleNamespace(
        read_h=np.concatenate([h, eh]).astype(np.int64),
        read_v=np.concatenate([v, ev]).astype(np.int64),
        pos_h=np.concatenate([pos_h, eph]).astype(np.int64),
        pos_v=np.concatenate([pos_v, epv]).astype(np.int64),
        seed_rc=np.concatenate([rc, erc]).astype(bool))


def prep_err(rd, blk, k: int, L: int) -> int:
    """K3 against its plain version on the same inputs on the card: 0
    when torch.equal holds on every output, else the largest |K3 - plain|
    (words compared as their int32 bit patterns)."""
    import torch

    from bella_tpu_torch.align import xdrop as X

    got = X.launch_prep(rd, blk, k, L)
    want = X.prepare_batch_plain(rd, blk, k, L)
    err = 0
    for key in PREP_KEYS:
        a, b = got[key], want[key]
        if a.shape != b.shape or a.dtype != b.dtype:
            raise AssertionError(f"K3 {key}: {a.dtype} {tuple(a.shape)}, "
                                 f"plain {b.dtype} {tuple(b.shape)}")
        if not torch.equal(a, b):
            err = max(err, int((a.to(torch.int64) - b.to(torch.int64)
                                ).abs().max()))
    return err


def level_against_batches(reads, pairs, config, label: str,
                          state: dict) -> list:
    """Every pair of a corpus as one level of the main path (both
    extensions, one descriptor-fed launch over the reads' words, longest
    first) against the form it replaced: K3 materialising the streams
    of align_batch pairs at a time, each batch's K1 (or K2 on the adaptive
    path) launch after it. Bit for bit, steps included; each form timed
    (CUDA events around its x-drop launches, K3 not counted) with its
    tails modelled (list_span over the kernel's own schedule, longest
    first on its resident warp groups). Returns the K3 calls (reads, pair
    block, k, L) of the batched form, for K3's row of the kernel table."""
    import torch

    from bella_tpu_torch.align import pallas_xdrop as P
    from bella_tpu_torch.align import xdrop as X
    from bella_tpu_torch.utils.measure import kernel_spans, span_ms

    adaptive = config.adaptive_aligner
    k, xdrop = int(config.kmer_size), int(config.xdrop)
    W = (int(config.band_width) if adaptive
         else P.round_band(config.pallas_band))
    rd = X._upload_reads(reads, "cuda")
    n = pairs.num_pairs
    sel = np.arange(n)
    lens = reads.lengths
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    slots = P.resident_extensions(W, adaptive)

    ext = X.extension_streams(rd, X._pair_block(pairs, sel, "cuda"), k)
    with kernel_spans() as whole:
        got = P.run_streams(ext["T"], ext["Q"], xdrop, W, P.NO_CAP, adaptive,
                            longest=int(pair_len.max()), with_steps=True)
    want = torch.empty_like(got)
    calls, batch_tails = [], []
    with kernel_spans() as batched:
        for idx, e in X.extension_batches(rd, pairs, sel, pair_len, k,
                                          config.align_batch):
            L = e["L"]
            cap = 2 * L if adaptive else P.static_step_cap(2 * L)
            o = P.run_xdrop(e["T"], e["t_len"], e["Q"], e["q_len"], xdrop, W,
                            cap, adaptive, with_steps=True)
            B = len(idx)
            at = torch.from_numpy(idx).cuda()
            want[:, at], want[:, n + at] = o[:, :B], o[:, B:]
            order = P.longest_first(e["t_len"], e["q_len"]).cpu().numpy()
            steps = o[3].cpu().numpy()
            batch_tails.append(tail_ratio(steps[order], slots))
            calls.append((rd, X._pair_block(pairs, sel[idx], "cuda"), k, L))
    torch.cuda.synchronize()
    err = int((got.to(torch.int64) - want.to(torch.int64)).abs().max())
    order = P.longest_first(ext["T"].len, ext["Q"].len).cpu().numpy()
    steps = got[3].cpu().numpy()
    info = dict(
        extensions=2 * n, W=W, slots=slots, err=err,
        whole_ms=sum(span_ms(v) for v in whole.values()),
        whole_launches=sum(len(v) for v in whole.values()),
        whole_tail=tail_ratio(steps[order], slots),
        batched_ms=sum(span_ms(v) for key, v in batched.items()
                       if key[0] != "ext_prep"),
        batched_launches=sum(len(v) for key, v in batched.items()
                             if key[0] != "ext_prep"),
        batched_k3_ms=sum(span_ms(v) for key, v in batched.items()
                          if key[0] == "ext_prep"),
        batched_tails=[min(batch_tails), float(np.median(batch_tails)),
                       max(batch_tails)],
        mean_steps=float(steps.mean()), max_steps=int(steps.max()))
    print(f"level {label}: " + json.dumps(info), flush=True)
    state.setdefault("levels", {})[label] = info
    if err:
        raise AssertionError(f"{label}: the descriptor-fed kernel disagrees "
                             "with K3 and the batched kernel")
    return calls


def phase_kernels(state: dict) -> None:
    """K1 and K2 against their plain versions, bit for bit (score, t_end,
    q_end and steps), on random pairs at every band the main path uses and
    on the cases the warp tiling and the work queue could get wrong."""
    from bella_tpu_torch.align import pallas_xdrop as P
    from bella_tpu_torch.align import xdrop as X
    from bella_tpu_torch.utils.measure import cuda_ms

    rng = np.random.default_rng(7)
    k1_errs, k2_errs = [], []

    def k1(label, batch, W, max_steps=0, chars=False):
        t0 = time.perf_counter()
        T, tl, Q, ql = batch
        Tw, Qw = P.pack_words(T), P.pack_words(Q)
        args = dict(band=W, max_steps=max_steps, with_steps=True)
        e = same(P.extend_batch_packed(Tw, tl, Qw, ql, 25, **args),
                 P.extend_batch_packed_plain(Tw, tl, Qw, ql, 25, **args))
        if chars:
            e = max(e, same(P.extend_batch_chars(T, tl, Q, ql, 25, band=W),
                            P.extend_batch_chars_plain(T, tl, Q, ql, 25,
                                                       band=W)))
        print(f"K1 {label} W={W}: max |kernel - plain| = {e} over "
              f"{T.shape[0]} pairs ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        k1_errs.append(e)

    def k2(label, batch, W, max_steps=0):
        t0 = time.perf_counter()
        T, tl, Q, ql = batch
        Tw, Qw = P.pack_words(T), P.pack_words(Q)
        cap = max_steps if max_steps > 0 else 2 * T.shape[1]
        names = ("score", "t_end", "q_end", "steps")
        k = P.run_xdrop(Tw, tl, Qw, ql, 25, W, cap, True, with_steps=True)
        p = P.xdrop_plain(Tw, tl, Qw, ql, 25, W, cap, True, with_steps=True)
        e = same(dict(zip(names, k)), dict(zip(names, p)))
        print(f"K2 {label} W={W}: max |kernel - plain| = {e} over "
              f"{T.shape[0]} pairs ({time.perf_counter() - t0:.1f} s)",
              flush=True)
        k2_errs.append(e)

    # the char entry packs and launches the same kernel: checked at one W
    for W in (128, 256, 512, 1024, 2048):
        k1("random 0-6000 bp" + (", packed and char entries" if W == 128
                                 else ""),
           random_batch(rng, 96, 6000), W, chars=W == 128)
    T, tl, Q, ql = random_batch(rng, 96, 6000)
    e = same(X.extend_batch(T, tl, Q, ql, 25, band=128),
             X.extend_batch_plain(T, tl, Q, ql, 25, band=128))
    print(f"K2 random 0-6000 bp, extend_batch entry W=128: max |kernel - "
          f"plain| = {e} over 96 pairs")
    k2_errs.append(e)

    one = [x[3:4].contiguous() for x in random_batch(rng, 5, 3000)]
    k1("B=1", one, 128)
    k2("B=1", one, 128)
    odd = random_batch(rng, 13, 2000)  # 13: no multiple of a block's groups
    for W in (128, 1024, 2048):
        k1("B=13", odd, W)
    last = pairs_of(rng, list(rng.integers(200, 800, 40)) + [5000])
    k1("longest extension last", last, 128)
    k2("longest extension last", last, 128)
    # lengths near 65,535: the plain version runs on the CPU in a
    # subprocess started with the script (~130,000 antidiagonals)
    import torch

    longest = [torch.from_numpy(x).cuda() for x in edge_batch()]
    T, tl, Q, ql = longest
    got = P.extend_batch_packed(P.pack_words(T), tl, P.pack_words(Q), ql,
                                25, band=128, with_steps=True)
    got = torch.stack([got[k] for k in ("score", "t_end", "q_end",
                                        "steps")]).cpu().numpy()
    path, proc = state["long_plain"]["K1 edge"]
    _, perr = proc.communicate(timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"K1 edge plain version failed:\n{perr[-3000:]}")
    e = int(np.abs(got.astype(np.int64)
                   - np.load(path)["out"].astype(np.int64)).max())
    print(f"K1 lengths near 65,535 W=128: max |kernel - plain| = {e} over "
          f"3 pairs (plain on the CPU)")
    k1_errs.append(e)
    # one step's latency: the longest extension alone on the card
    T, tl, Q, ql = (x[:1].contiguous() for x in longest)
    Tw, Qw = P.pack_words(T), P.pack_words(Q)
    steps = int(P.extend_batch_packed(Tw, tl, Qw, ql, 25, band=128,
                                      with_steps=True)["steps"][0])
    ms = cuda_ms(lambda: P.extend_batch_packed(Tw, tl, Qw, ql, 25, band=128))
    state["step_ns"] = 1e6 * ms / steps
    print(f"K1 one extension alone, W=128: {steps} steps in {ms:.3f} ms, "
          f"{state['step_ns']:.1f} ns a step")
    capped = random_batch(rng, 24, 3000)
    k1("max_steps=500 (cap 640)", capped, 256, max_steps=500)
    k2("max_steps=500", capped, 128, max_steps=500)
    k1("W not a power of two", capped, 384)
    mixed = random_batch(rng, 48, 3000)
    for W in (31, 64, 100, 1024):  # 31: the reference's band, not rounded
        k2("random 0-3000 bp", mixed, W)
    state["k1_err"], state["k2_err"] = max(k1_errs), max(k2_errs)
    state["k3_err"] = phase_kernels_prep()
    if state["k1_err"] or state["k2_err"] or state["k3_err"]:
        raise AssertionError("a kernel disagrees with its plain version")


def phase_kernels_prep() -> int:
    """K3 against its plain version on seeded batches; returns the max
    error (0 when every output is equal)."""
    from bella_tpu_torch.align import xdrop as X

    rng = np.random.default_rng(3)

    def case(label, lens, n, k, must, wider=0):
        t0 = time.perf_counter()
        reads = prep_reads(rng, lens)
        pairs = prep_pairs(rng, lens, n, k, must)
        rd = X._upload_reads(reads, "cuda")
        rows = np.arange(len(pairs.read_h))
        L = -(-int(np.maximum(reads.lengths[pairs.read_h],
                              reads.lengths[pairs.read_v]).max()) // 16) * 16
        e = prep_err(rd, X._pair_block(pairs, rows, "cuda"), k, L + wider)
        print(f"K3 {label}: B={len(rows)} L={L + wider} k={k}: max |K3 - "
              f"plain| = {e} ({time.perf_counter() - t0:.1f} s)", flush=True)
        return e

    def odd(lens):  # lengths that are no multiple of 16
        lens = np.asarray(lens, np.int64)
        return np.where(lens % 16 == 0, lens + 1, lens)

    mixed = odd(rng.integers(1, 9001, 400))
    mixed[0], mixed[-1] = 4097, 8999  # read 0 and the last read take seeds
    last = len(mixed) - 1
    errs = [case("lengths 1-9,000", mixed, 1000, k, (0, last))
            for k in (17, 31)]
    errs.append(case("width 256 bases beyond the reads", mixed, 200, 17,
                     (0, last), wider=256))
    errs.append(case("one pair", mixed, 1, 17, ()))
    long_lens = odd(np.concatenate([rng.integers(500, 3000, 30),
                                    [131_085], rng.integers(500, 3000, 30)]))
    errs.append(case("a read of 131,085 bases", long_lens, 40, 17,
                     (0, 30, len(long_lens) - 1)))
    short = odd(rng.integers(40, 401, 3000))
    errs.append(case("17,000 pairs (68,000 rows)", short, 17_000, 17,
                     (0, len(short) - 1)))
    return max(errs)


def cards(mesh=None) -> list:
    """The distinct cards a run uses: the group's, or cuda:0."""
    import torch

    devs = [torch.device("cuda", 0)] if mesh is None else mesh.devices
    return list({str(d): d for d in devs}.values())


def run_main(reads, config, label: str, state: dict, truth=None, mesh=None):
    """Drive run_pipeline (over `mesh` when given) with the launch counts
    reset just before and read just after, this slice's torch ops timed
    and, given the simulator's truth, the rows scored; returns (result,
    counts)."""
    import torch

    from bella_tpu_torch.align import _build
    from bella_tpu_torch.pipeline import run_pipeline
    from bella_tpu_torch.utils import log as ulog
    from bella_tpu_torch.utils.measure import (
        kernel_spans, op_spans, span_ms,
    )

    for d in cards(mesh):
        torch.cuda.reset_peak_memory_stats(d)
        torch.cuda.synchronize(d)
    ulog.reset()
    t0 = time.perf_counter()
    with kernel_spans() as spans, op_spans(SLICE_OPS, CAPTURED) as (ops,
                                                                 checks):
        res = run_pipeline(reads, config, mesh=mesh)
    for d in cards(mesh):
        torch.cuda.synchronize(d)
    wall = time.perf_counter() - t0
    counts = _build.launches()
    op_ms = {k: span_ms(v) for k, v in ops.items()}
    kernel_ms = {k: 0.0 for k in counts}
    by_band, by_shard = {}, {}
    for (k, W, shard), v in sorted(spans.items(), key=str):
        ms = span_ms(v)
        kernel_ms[k] += ms
        band = by_band.setdefault(f"{k} W={W}" if W else k,
                                  dict(ms=0.0, launches=0))
        band["ms"] += ms
        band["launches"] += len(v)
        if shard is not None:
            one = by_shard.setdefault(f"{k} shard {shard}",
                                      dict(ms=0.0, launches=0))
            one["ms"] += ms
            one["launches"] += len(v)
    secs = dict(ulog.PHASE_SECONDS)
    aln = res.alignment
    aligned = int((aln.end_h - aln.beg_h).sum() + (aln.end_v - aln.beg_v).sum())
    total_bases = int(reads.lengths.sum())
    det = secs.get("overlapDetection", 0.0)
    ad = secs.get("alignment", 0.0) + secs.get("decision", 0.0)
    info = dict(
        label=label, reads=reads.num_reads, bases=total_bases, nnz=res.nnz,
        pairs=res.pairs.num_pairs, aligned_bases=aligned,
        passed=res.num_output, levels=list(aln.rescue_levels),
        tail_pairs=len(aln.tail_pairs), launches=counts, kernel_ms=kernel_ms,
        kernel_by_band=by_band, detect_s=det, align_decide_s=ad, wall_s=wall,
        detect_bases_per_s=total_bases / det if det else None,
        align_decide_bases_per_s=aligned / ad if ad else None,
        phase_s=secs,
        peak_mem_bytes=max(int(torch.cuda.max_memory_allocated(d))
                           for d in cards(mesh)),
        op_ms=op_ms, op_share_of_wall={k: v / 1e3 / wall
                                       for k, v in op_ms.items()},
        checks={k: [list(x) if isinstance(x, tuple) else x for x in v]
                for k, v in checks.items()},
        bounds=[config.lower_freq, config.upper_freq],
        xdrop_extensions=ulog.COUNTS.get("xdrop.extensions", 0),
        syncs=ulog.COUNTS.get("sync.align", 0),
    )
    if mesh is not None:
        info.update(
            shards=mesh.describe(), kernel_by_shard=by_shard,
            exchange_s=mesh.exchange_seconds,
            exchange_bytes=mesh.exchange_bytes,
            peak_mem_bytes_by_device={
                str(d): int(torch.cuda.max_memory_allocated(d))
                for d in cards(mesh)})
    if truth is not None:
        info.update(score_rows(res.rows, truth, config.output_paf,
                               state["work"]))
    print("main path " + json.dumps(info))
    state.setdefault("runs", {})[label] = info
    if not all(np.isfinite(res.alignment.score)) or len(res.rows) != res.num_output:
        raise AssertionError(f"{label}: malformed output")
    extensions = counts["xdrop_static"] + counts["xdrop_adaptive"]
    if counts["ext_prep"] or (res.pairs.num_pairs and not
                              config.skip_alignment and not extensions):
        raise AssertionError(f"{label}: the main path launched K3, or no "
                             f"x-drop kernel: {counts}")
    return res, counts


def phase_bench(state: dict) -> None:
    from bench_torch import bench_corpus
    from bella_tpu_torch.config import BellaConfig

    reads = bench_corpus()
    state["bench_reads"] = reads
    res, counts = run_main(reads, BellaConfig(), "bench", state)
    state["bench_result"] = res
    info = state["runs"]["bench"]
    got = dict(nnz=info["nnz"], pairs=info["pairs"],
               aligned=info["aligned_bases"], passed=info["passed"],
               levels=tuple(tuple(x) for x in info["levels"]))
    want = BENCH_ANCHORS
    if got != want:
        raise AssertionError(f"bench anchors differ: got {got}, want {want}")
    if counts["xdrop_static"] <= 0:
        raise AssertionError("the main path launched no K1")
    state["k1_launches"] = counts["xdrop_static"]
    print(f"bench anchors hold: {got}")
    level_against_batches(reads, res.pairs, BellaConfig(), "bench", state)

    # the exactness tail: with the static cascade capped at 256 lanes the
    # pairs still saturated at 256 re-extend through K2
    res2, counts2 = run_main(reads, BellaConfig(rescue_ceiling=256),
                             "bench_ceiling256", state)
    if counts2["xdrop_adaptive"] <= 0 or not len(res2.alignment.tail_pairs):
        raise AssertionError("the capped cascade launched no K2")
    state["k2_launches"] = counts2["xdrop_adaptive"]
    state["tail_pairs"] = res2.alignment.tail_pairs
    if res2.pairs.num_pairs != res.pairs.num_pairs:
        raise AssertionError("capped-cascade run is malformed")


def phase_small(state: dict) -> None:
    """The whole path on a small corpus: the card's M4 rows equal the
    rows of the CPU run, which takes every kernel's plain version."""
    import tempfile

    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.simulate import random_genome, sample_reads
    from bella_tpu_torch.pipeline import run_pipeline

    g = random_genome(12_000, seed=11)
    reads, _ = sample_reads(g, 40, mean_len=1500, min_len=500,
                            error_rate=0.15, seed=12, circular=False)
    cfg = dict(rescue_ceiling=256)
    gpu = run_pipeline(reads, BellaConfig(**cfg))
    cpu = run_pipeline(reads, BellaConfig(**cfg), device="cpu")
    print(f"small corpus: {gpu.pairs.num_pairs} pairs, {gpu.num_output} rows, "
          f"cascade {gpu.alignment.rescue_levels}, "
          f"tail {len(gpu.alignment.tail_pairs)}; card rows == CPU rows: "
          f"{gpu.rows == cpu.rows}")
    if gpu.rows != cpu.rows or not gpu.rows:
        raise AssertionError("card and CPU rows differ on the small corpus")
    # every mode of the modes and hifi phases on smaller corpora (15 % and
    # 0.5 % error): card rows and scores == CPU rows and scores
    noisy, _ = sample_reads(random_genome(6_000, seed=15), 20,
                            mean_len=1000, min_len=500, error_rate=0.15,
                            seed=16, circular=False)
    hifi, _ = sample_reads(random_genome(6_000, seed=13), 20, mean_len=1000,
                           min_len=500, error_rate=0.005, seed=14,
                           circular=False)
    bad = []
    with tempfile.TemporaryDirectory() as work:
        for corpus, kw in [(noisy, m) for _, m in MODES] + [
                (noisy, dict(checkpoint=os.path.join(work, "ck.npz")))] + [
                (hifi, m) for _, m in HIFI_MODES] + [
                (noisy, dict(aligner_backend="jax")),
                (noisy, dict(aligner_backend="jax", band_width=31,
                             max_steps=500))]:
            gpu = run_pipeline(corpus, BellaConfig(**kw))
            cpu = run_pipeline(corpus, BellaConfig(**kw), device="cpu")
            ok = (gpu.rows == cpu.rows and gpu.pairs.num_pairs > 0
                  and np.array_equal(gpu.alignment.score,
                                     cpu.alignment.score))
            print(f"small corpus {kw}: {gpu.pairs.num_pairs} pairs, "
                  f"{gpu.num_output} rows; card == CPU: {ok}")
            if not ok:
                bad.append(str(kw))
    if bad:
        raise AssertionError(f"card and CPU rows differ in modes {bad}")


def phase_demo(state: dict) -> None:
    from bench_torch import demo_corpus
    from bella_tpu_torch.config import BellaConfig

    t0 = time.perf_counter()
    g, reads, truth = demo_corpus()
    state["demo_genome"], state["demo_truth"] = g, truth
    print(f"dataset D: {reads.num_reads} reads, "
          f"{int(reads.lengths.sum())} bases, made in "
          f"{time.perf_counter() - t0:.1f} s")
    res, _ = run_main(reads, BellaConfig(), "demo", state, truth=truth)
    state["demo_reads"], state["demo_pairs"] = reads, res.pairs
    state["demo_rows"], state["demo_scores"] = res.rows, res.alignment.score
    info = state["runs"]["demo"]
    for key, v in info["kernel_by_band"].items():
        print(f"demo in-path {key}: {v['ms']:.1f} ms in {v['launches']} "
              f"launches")
    got = dict(nnz=info["nnz"], pairs=info["pairs"], rows=info["passed"],
               levels=tuple(tuple(x) for x in info["levels"]),
               tail_pairs=info["tail_pairs"])
    if got != DEMO_ANCHORS:
        raise AssertionError(f"demo anchors differ: got {got}, "
                             f"want {DEMO_ANCHORS}")
    print(f"demo anchors hold: {got}")
    # the first pass as one level against its former batches; their K3
    # calls give K3's row of the kernel table
    state["demo_prep_calls"] = level_against_batches(
        reads, res.pairs, BellaConfig(), "demo", state)


def phase_adaptive(state: dict) -> None:
    """Dataset D on the adaptive-band backend: K2 at band_width on both
    extensions of every pair, no cascade, no tail. Its detection is the
    demo's; its rows are anchored, scored and set against the static
    path's. Then every extension again through K2 with steps (K2's time
    and bound for the kernel table), a sample of D's pairs through K2 and
    its plain version on the card, and the bench corpus over two shards
    against one device."""
    import torch

    from bella_tpu_torch.align import _build
    from bella_tpu_torch.align import pallas_xdrop as P
    from bella_tpu_torch.align import xdrop as X
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.utils.measure import cuda_ms

    reads = state["demo_reads"]
    cfg = BellaConfig(aligner_backend="jax")
    label = "demo adaptive"
    res, counts = run_main(reads, cfg, label, state,
                           truth=state["demo_truth"])
    info = state["runs"][label]
    got = dict(nnz=info["nnz"], pairs=info["pairs"], rows=info["passed"],
               levels=info["levels"], tail_pairs=info["tail_pairs"])
    static = set(state["demo_rows"])
    rows = set(res.rows)
    d_score = res.alignment.score.astype(np.int64) - state["demo_scores"]
    print(f"{label}: nnzA {res.nnz}, {res.pairs.num_pairs} pairs, "
          f"{res.num_output} rows (static path {len(static)}: "
          f"{len(rows - static)} rows only here, {len(static - rows)} only "
          f"there; scores higher on {int((d_score > 0).sum())} pairs, lower "
          f"on {int((d_score < 0).sum())}); K2 "
          f"{info['kernel_ms'].get('xdrop_adaptive', 0.0):.1f} ms in "
          f"{counts['xdrop_adaptive']} launches, K1 launches "
          f"{counts['xdrop_static']}; align {info['phase_s'].get('alignment', 0):.2f} s, "
          f"wall {info['wall_s']:.2f} s, peak "
          f"{info['peak_mem_bytes'] / 1e9:.2f} GB; RC "
          f"{info.get('recall', 0):.2f} PR {info.get('precision', 0):.2f}",
          flush=True)
    if (got["nnz"], got["pairs"]) != (DEMO_ANCHORS["nnz"],
                                      DEMO_ANCHORS["pairs"]):
        raise AssertionError(f"{label}: detection anchors differ: {got}")
    if got["levels"] or got["tail_pairs"]:
        raise AssertionError(f"{label}: the adaptive path ran a cascade")
    if counts["xdrop_adaptive"] != 1 or counts["xdrop_static"]:
        raise AssertionError(f"{label}: K2 was not the path's one launch: "
                             f"{counts}")
    if ADAPTIVE_ANCHORS is not None and got != ADAPTIVE_ANCHORS:
        raise AssertionError(f"{label} anchors differ: got {got}, want "
                             f"{ADAPTIVE_ANCHORS}")

    # every extension of the path again, with steps, as the path runs
    # them (one descriptor-fed launch) and as the batches of K3 and K2 it
    # ran before: K2 alone on D
    level_against_batches(reads, res.pairs, cfg, label, state)
    lv = state["levels"][label]
    pairs = res.pairs
    rd = X._upload_reads(reads, "cuda")
    lens = reads.lengths
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    W = int(cfg.band_width)
    ext = X.extension_streams(
        rd, X._pair_block(pairs, np.arange(pairs.num_pairs), "cuda"),
        cfg.kmer_size)
    before = _build.launches()
    out = P.run_streams(ext["T"], ext["Q"], cfg.xdrop, W, P.NO_CAP, True,
                        longest=int(pair_len.max()), with_steps=True)
    rerun = sum(_build.launches()[k] - before[k]
                for k in ("xdrop_static", "xdrop_adaptive"))
    steps = int(out[3].sum())
    n_ext = int(out.shape[1])
    byts = stream_bytes(reads, n_ext)
    bound, by = _bound_of(byts, OPS_PER_CELL * W * steps)
    k2_ms = cuda_ms(lambda: P.run_streams(
        ext["T"], ext["Q"], cfg.xdrop, W, P.NO_CAP, True,
        longest=int(pair_len.max())))
    print(f"{label}: K2 alone on its {n_ext} extensions in {rerun} launches, "
          f"W={W}: {k2_ms:.1f} ms ({lv['batched_ms']:.1f} ms in "
          f"{lv['batched_launches']} batched launches), {steps} "
          f"antidiagonals (mean {steps / max(n_ext, 1):.1f}), bound "
          f"{bound:.3f} ms ({by}), {100 * bound / k2_ms:.2f} % of it",
          flush=True)
    del ext, out

    # a sample of D's pairs: K2 against its plain version on the card
    rng = np.random.default_rng(6)
    sel = np.sort(rng.choice(pairs.num_pairs, ADAPTIVE_SAMPLE, replace=False))
    e = X.extension_streams(rd, X._pair_block(pairs, sel, "cuda"),
                            cfg.kmer_size)
    L = -(-int(pair_len[sel].max()) // 16) * 16
    args = (e["T"], e["Q"], cfg.xdrop, W, P.NO_CAP, True)
    kern = P.run_streams(*args, longest=L, with_steps=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain = P.xdrop_plain(P.stream_rows(e["T"], L), e["T"].len,
                          P.stream_rows(e["Q"], L), e["Q"].len, cfg.xdrop, W,
                          P.NO_CAP, True, with_steps=True)
    torch.cuda.synchronize()
    plain_ms = 1e3 * (time.perf_counter() - t0)
    sample_ms = cuda_ms(lambda: P.run_streams(*args, longest=L))
    err = int((kern.to(torch.int64) - plain.to(torch.int64)).abs().max())
    print(f"{label}: K2 on {len(sel)} of D's pairs ({kern.shape[1]} "
          f"extensions, L={L}): max |kernel - plain| = {err} (score, "
          f"ends, steps); kernel {sample_ms:.3f} ms, plain on the card "
          f"{plain_ms:.1f} ms", flush=True)
    state["adaptive"] = dict(
        launches=counts["xdrop_adaptive"],
        in_path_ms=info["kernel_ms"].get("xdrop_adaptive", 0.0), ms=k2_ms,
        bound_ms=bound, bound_by=by, extensions=n_ext, rerun_launches=rerun,
        antidiagonals=steps, W=W, sample_err=err, sample_plain_ms=plain_ms,
        sample_ms=sample_ms, sample_extensions=int(kern.shape[1]),
        batched_ms=lv["batched_ms"], batched_launches=lv["batched_launches"])
    if err:
        raise AssertionError("K2 disagrees with its plain version on D")
    del rd, e, args, kern, plain

    # the bench corpus over two shards equals one device
    bench = state["bench_reads"]
    one, _ = run_main(bench, cfg, "bench adaptive", state)
    two, c2 = run_main(bench, BellaConfig(aligner_backend="jax", devices=2),
                       "bench adaptive, 2 shards", state,
                       mesh=shard_group(2))
    by_shard = state["runs"]["bench adaptive, 2 shards"]["kernel_by_shard"]
    shards = {k for k, v in by_shard.items()
              if k.startswith("xdrop_adaptive") and v["launches"] > 0}
    ok = (one.rows == two.rows and len(shards) == 2 and all(
        np.array_equal(getattr(one.alignment, f), getattr(two.alignment, f))
        for f in ("score", "beg_h", "end_h", "beg_v", "end_v")))
    print(f"bench adaptive: {one.num_output} rows; over 2 shards ("
          + json.dumps(by_shard) + f") equal to one device: {ok}")
    if not ok:
        raise AssertionError("the adaptive path over 2 shards differs")


# ----------------------------------------------------------------------
# long extensions, the memory ladder, large corpora
# ----------------------------------------------------------------------


def long_batch():
    """Two near-identical extensions just above 2^17 bases a side (3 % and
    1 % substitutions, no indels): the path stays on the diagonal, so the
    score and w = value + d grow large. numpy arrays (T, t_len, Q, q_len)."""
    rng = np.random.default_rng(1717)
    lens = [LONG_BASES, LONG_BASES - 61]
    T = np.zeros((2, LONG_BASES), np.uint8)
    Q = np.zeros((2, LONG_BASES), np.uint8)
    for b, (n, p) in enumerate(zip(lens, (0.03, 0.01))):
        t = rng.integers(0, 4, n).astype(np.uint8)
        q = t.copy()
        sub = rng.random(n) < p
        q[sub] = (q[sub] + 1) % 4
        T[b, :n], Q[b, :n] = t, q
    n = np.asarray(lens, np.int32)
    return T, n, Q, n.copy()


def _long_args(adaptive: bool):
    """(W, step cap) of the long phase: K2 at band_width 128 with the
    default cap 2 L; K1 at W = 128 with extend_batch_packed's default."""
    from bella_tpu_torch.align import pallas_xdrop as P

    if adaptive:
        return 128, 2 * LONG_BASES
    return P.round_band(128), P.static_step_cap(2 * 16 * -(-LONG_BASES // 16))


def long_plain_main(path: str, case: str) -> None:
    """Subprocess body, on the CPU: the plain version of K1 (static) or K2
    (adaptive) on long_batch(), or of K1 on edge_batch() as the kernels
    phase launches it, with steps, and its time."""
    import torch

    from bella_tpu_torch.align import pallas_xdrop as P

    torch.set_num_threads(1)
    t0 = time.perf_counter()
    if case == "K1 edge":
        T, tl, Q, ql = (torch.from_numpy(a) for a in edge_batch())
        o = P.extend_batch_packed_plain(P.pack_words(T), tl, P.pack_words(Q),
                                        ql, 25, band=128, with_steps=True)
        out = torch.stack([o[k] for k in ("score", "t_end", "q_end",
                                          "steps")])
    else:
        adaptive = case == "K2"
        T, tl, Q, ql = (torch.from_numpy(a) for a in long_batch())
        W, cap = _long_args(adaptive)
        out = P.xdrop_plain(P.pack_words(T), tl, P.pack_words(Q), ql,
                            LONG_XDROP, W, cap, adaptive, with_steps=True)
    np.savez(path, out=out.numpy(), ms=1e3 * (time.perf_counter() - t0))


def start_long_plain(workdir: str) -> dict:
    """Start the plain versions of the long phase and of the kernels
    phase's edge case on the CPU, in the background (each takes from half
    a minute to a minute or more)."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="",
               PYTHONPATH=os.pathsep.join(
                   [here, os.environ.get("PYTHONPATH", "")]))
    procs = {}
    for name in ("K1", "K2", "K1 edge"):
        path = os.path.join(workdir, f"{name.replace(' ', '_')}.npz")
        code = (f"import chip_smoke; "
                f"chip_smoke.long_plain_main({path!r}, {name!r})")
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-c", code], cwd=here, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    return procs


def phase_long(state: dict) -> None:
    """K1 and K2 above 2^17 bases against their plain versions, bit for
    bit; the long-key instantiation against the int32 one where both
    hold; the wrappers' choice of key."""
    import torch

    from bella_tpu_torch.align import _build
    from bella_tpu_torch.align import pallas_xdrop as P
    from bella_tpu_torch.utils.measure import cuda_ms

    T, tl, Q, ql = (torch.from_numpy(a).cuda() for a in long_batch())
    Tw, Qw = P.pack_words(T), P.pack_words(Q)
    errs = []
    state["long"] = {}
    for name, adaptive in (("K1", False), ("K2", True)):
        W, cap = _long_args(adaptive)
        count = ("xdrop_adaptive" if adaptive else "xdrop_static") + "_long_key"
        before = _build.launches()[count]
        out = P.run_xdrop(Tw, tl, Qw, ql, LONG_XDROP, W, cap, adaptive,
                          with_steps=True)
        if _build.launches()[count] != before + 1:
            raise AssertionError(f"{name}: the wrapper took the int32 key "
                                 "above 2^17")
        ms = cuda_ms(lambda: P.run_xdrop(Tw, tl, Qw, ql, LONG_XDROP, W, cap,
                                         adaptive))
        path, proc = state["long_plain"][name]
        _, perr = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"{name} plain version failed:\n{perr[-3000:]}")
        z = np.load(path)
        got = out.cpu().numpy().astype(np.int64)
        e = int(np.abs(got - z["out"].astype(np.int64)).max())
        errs.append(e)
        bound, by = _bound_ms([(Tw, tl, Qw, ql, None)], [out[3]], W)
        state["long"][name] = dict(
            ms=ms, plain_ms=float(z["ms"]), err=e, bound_ms=bound,
            bound_by=by, W=W, lengths=tl.tolist(), score=got[0].tolist(),
            t_end=got[1].tolist(), steps=got[3].tolist())
        print(f"{name} long key, 2 extensions of {tl.tolist()} bases a side, "
              f"W={W}: max |kernel - plain| = {e}; " + json.dumps(
                  state["long"][name]), flush=True)
    # the long-key instantiation against the int32 one, kernel to kernel
    rng = np.random.default_rng(17)
    Tb, tlb, Qb, qlb = random_batch(rng, 48, 3000)
    Twb, Qwb = P.pack_words(Tb), P.pack_words(Qb)
    ts, qs = P.row_streams(Twb, tlb), P.row_streams(Qwb, qlb)
    for adaptive, bands in ((False, (128, 256, 384, 512, 1024, 2048)),
                            (True, (64, 100, 128, 1024))):
        cap = 6000 if adaptive else P.static_step_cap(2 * 16 * Twb.shape[1])
        for W in bands:
            a = P.launch_streams(ts, qs, 25, W, cap, adaptive, True,
                                 long_key=False)
            b = P.launch_streams(ts, qs, 25, W, cap, adaptive, True,
                                 long_key=True)
            e = int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
            errs.append(e)
            print(f"{'K2' if adaptive else 'K1'} W={W}: max |long key - int32 "
                  f"key| = {e} over 48 pairs (score, ends, steps)")
    # below 2^17 the wrappers take the int32 key
    before = _build.launches()
    P.extend_batch_packed(Twb, tlb, Qwb, qlb, 25, band=128)
    P.run_xdrop(Twb, tlb, Qwb, qlb, 25, 128, 6000, True)
    took = {k: v - before[k] for k, v in _build.launches().items()}
    print(f"wrappers below 2^17: launches {took}")
    if took != {"xdrop_static": 1, "xdrop_adaptive": 1, "ext_prep": 0,
                "xdrop_static_long_key": 0, "xdrop_adaptive_long_key": 0}:
        raise AssertionError("a wrapper took the long key below 2^17")
    if any(errs):
        raise AssertionError("the long-key kernels disagree")


def check_pairs(pairs, k: int, label: str) -> None:
    """The pair invariants of detection."""
    ok = (bool((pairs.read_h > pairs.read_v).all())
          and bool((pairs.matches >= 1).all())
          and bool((pairs.count >= pairs.matches).all())
          and bool((pairs.overlap_est >= k).all()))
    if not ok or not pairs.num_pairs:
        raise AssertionError(f"{label}: pair invariants fail")


def same_pairs(a, b) -> bool:
    """Field for field (both sorted by (read_h, read_v))."""
    import dataclasses

    return a.num_pairs == b.num_pairs and all(
        np.array_equal(getattr(a, f.name), getattr(b, f.name))
        for f in dataclasses.fields(a))


def budget_for(reads, per_base: float):
    """BellaConfig(total_memory_mb) of per_base bytes a base (rounded up,
    so a rung's gate, total * per_base <= budget, holds)."""
    from bella_tpu_torch.config import BellaConfig

    return BellaConfig(total_memory_mb=(len(reads.codes) * per_base + 1) / 1e6)


def flip_ties(single, other) -> int:
    """Pairs whose seed differs between the single pass and the unpacked
    branch's seed rule. The packed branch orders a bin's rows by (pos_h,
    flip, pos_v), the unpacked one (host-staged triples, as in bella_tpu)
    by (pos_h, pos_v): at a pos_h with two rows of the other flip, it
    takes the one with the lower pos_v. Raises on any other difference."""
    if single.num_pairs != other.num_pairs:
        raise AssertionError("the pair lists differ in length")
    d = np.zeros(single.num_pairs, bool)
    for f in ("read_h", "read_v", "pos_h", "count", "matches"):
        if not np.array_equal(getattr(single, f), getattr(other, f)):
            raise AssertionError(f"{f} differs")
    for f in ("pos_v", "overlap_est", "seed_rc"):
        d |= getattr(single, f) != getattr(other, f)
    if not ((~single.seed_rc[d]).all() and other.seed_rc[d].all()
            and (other.pos_v[d] < single.pos_v[d]).all()):
        raise AssertionError("a seed differs other than by a flip tie")
    return int(d.sum())


def detect_only(reads, config, label: str, state: dict):
    """detect_overlaps alone, with its seconds and peak allocation."""
    import torch

    from bella_tpu_torch.overlap import pairs as PP

    rung = PP.detection_rung(reads, config)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    pairs, nk, nnz = PP.detect_overlaps(reads, config)
    torch.cuda.synchronize()
    total = len(reads.codes)
    info = dict(label=label, rung=rung, seconds=time.perf_counter() - t0,
                peak_bytes=int(torch.cuda.max_memory_allocated()),
                bases=total, budget_mb=config.effective_memory_mb,
                num_kmers=nk, nnz=nnz, pairs=pairs.num_pairs)
    info["peak_bytes_per_base"] = info["peak_bytes"] / total
    info["peak_over_budget"] = info["peak_bytes"] / (info["budget_mb"] * 1e6)
    print("detection " + json.dumps(info), flush=True)
    state.setdefault("detect", {})[label] = info
    return pairs, nk, nnz


def phase_ladder(state: dict) -> None:
    """Dataset D at budgets that pick each rung beyond the single pass, the
    staged chain at both ends of its band, each equal to the single pass
    (the triples rung but for its flip ties); generate_candidates on D's
    triples at the edges of its packed and one-stage gates, within their
    budgets, the packed one equal to the single pass; the bench corpus
    through the modular branch at split_count = 2, equal to
    split_count = 1. Each run prints its peak against its budget."""
    import torch

    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.kmers.count import build_reliable_triples
    from bella_tpu_torch.overlap import pairs as PP

    reads, ref = state["demo_reads"], state["demo_pairs"]
    detect_only(reads, BellaConfig(), "demo single pass", state)
    bad = []
    for rung, per_base in (("split", PP.SPLIT_BYTES),
                           ("staged", 0.95 * PP.SPLIT_BYTES),
                           ("staged", PP.STAGED_BYTES),
                           ("triples", PP.STAGED_BYTES / 2)):
        label = f"demo {rung} at {per_base:g} B/base"
        pairs, _, nnz = detect_only(reads, budget_for(reads, per_base),
                                    label, state)
        info = state["detect"][label]
        ok = info["rung"] == rung and nnz == DEMO_ANCHORS["nnz"]
        if rung == "triples":
            ties = flip_ties(ref, pairs)
            ok = ok and ties == DEMO_FLIP_TIES
            print(f"ladder rung triples: {ties} pairs seeded by the "
                  f"unpacked rule's flip tie, the rest equal")
        else:  # the rungs the budget bounds stay within it
            ok = (ok and same_pairs(pairs, ref)
                  and info["peak_over_budget"] <= 1)
        print(f"ladder rung {info['rung']} at {per_base:g} B/base: nnzA "
              f"{nnz}, {pairs.num_pairs} pairs, peak {info['peak_bytes']} "
              f"bytes ({info['peak_over_budget']:.3f} of the budget), as the "
              f"single pass: {ok}")
        if not ok:
            bad.append(label)
    tri = build_reliable_triples(reads, BellaConfig())
    expanded = tri.nnz * (BellaConfig().upper_freq - 1)
    # each at the edge of its gate: the packed rule at TRIPLE_BYTES a
    # triple; the unpacked one stage (bin_size = 2) at ROW_BYTES an
    # expanded row
    for label, cfg, unit in (
            ("packed", BellaConfig(total_memory_mb=(
                tri.nnz * PP.TRIPLE_BYTES + 1) / 1e6), tri.nnz),
            ("unpacked, one stage", BellaConfig(bin_size=2, total_memory_mb=(
                expanded * PP.ROW_BYTES + 1) / 1e6), expanded)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        got = PP.generate_candidates(tri, reads.lengths, cfg)
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated())
        ok = (tri.nnz == DEMO_ANCHORS["nnz"]
              and peak <= cfg.total_memory_mb * 1e6)
        if label == "packed":
            ok = ok and same_pairs(got, ref)
        else:
            check_pairs(got, cfg.kmer_size, label)
        print("generate_candidates " + json.dumps(dict(
            label=f"demo triples, {label}", triples=tri.nnz,
            seconds=time.perf_counter() - t0, peak_bytes=peak,
            peak_bytes_per_unit=peak / unit, pairs=got.num_pairs,
            peak_over_budget=peak / (cfg.total_memory_mb * 1e6))))
        print(f"generate_candidates on D's triples, {label}, at the edge "
              f"of its gate: {got.num_pairs} pairs, within the budget"
              + (" and as the single pass" if label == "packed" else "")
              + f": {ok}")
        if not ok:
            bad.append(f"generate_candidates, {label}")
    del tri
    one = state["bench_result"]
    two, counts = run_main(state["bench_reads"], BellaConfig(split_count=2),
                           "bench_split2", state)
    ok = (two.nnz == BENCH_ANCHORS["nnz"] and two.num_output ==
          BENCH_ANCHORS["passed"] and same_pairs(two.pairs, one.pairs)
          and two.rows == one.rows and counts["xdrop_static"] > 0)
    print(f"bench at split_count 2: nnzA {two.nnz}, {two.pairs.num_pairs} "
          f"pairs, {two.num_output} rows; equal to split_count 1: {ok}")
    if not ok:
        bad.append("split_count 2")
    if bad:
        raise AssertionError(f"ladder runs differ: {bad}")


def corpus_run(reads, label: str, anchors, state: dict):
    """The main path on a corpus, its pair invariants, its anchors."""
    from bella_tpu_torch.config import BellaConfig

    res, counts = run_main(reads, BellaConfig(), label, state)
    check_pairs(res.pairs, BellaConfig().kmer_size, label)
    if counts["xdrop_static"] <= 0:
        raise AssertionError(f"{label}: the main path launched no K1")
    info = state["runs"][label]
    got = dict(nnz=info["nnz"], pairs=info["pairs"], rows=info["passed"],
               levels=tuple(tuple(x) for x in info["levels"]),
               tail_pairs=info["tail_pairs"])
    print(f"{label} anchors: {got}")
    if anchors is not None and got != anchors:
        raise AssertionError(f"{label} anchors differ: got {got}, "
                             f"want {anchors}")
    return res


def phase_wide(state: dict) -> None:
    """A yeast-sized corpus (70,583 reads, 35X) through the wide-id
    branch, then its detection on the fused split path."""
    import torch

    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.simulate import random_genome, sample_reads
    from bella_tpu_torch.overlap import pairs as PP

    t0 = time.perf_counter()
    g = random_genome(12_100_000, seed=501)
    reads, _ = sample_reads(g, 70_583, mean_len=6000, min_len=1000,
                            error_rate=0.15, seed=502, circular=False)
    total = len(reads.codes)
    print(f"wide corpus: {reads.num_reads} reads, {total} bases, made in "
          f"{time.perf_counter() - t0:.1f} s")
    single, nk, nnz = detect_only(reads, BellaConfig(), "wide single pass",
                                  state)
    state["wide"] = reads, single, nk, nnz
    info = state["detect"]["wide single pass"]
    # the single-pass gate at its edge on this card
    mem = torch.cuda.get_device_properties(0).total_memory
    per_pos = info["peak_bytes"] / (total - 16)
    edge = mem / PP.SINGLE_PASS_BYTES
    print(f"single-pass gate: {PP.SINGLE_PASS_BYTES} B/position admits "
          f"{edge:.4g} positions on {mem} bytes; at this corpus's "
          f"{per_pos:.2f} B/position peak the edge needs "
          f"{edge * per_pos / mem:.3f} of the card")
    if info["rung"] != "wide":
        raise AssertionError(f"the wide corpus took {info['rung']}")
    res = corpus_run(reads, "wide", WIDE_ANCHORS, state)
    if int(res.pairs.read_h.max()) <= 0xFFFF or not same_pairs(res.pairs,
                                                               single):
        raise AssertionError("wide: no read id beyond 16 bits, or the "
                             "pipeline's pairs differ")
    split, nk2, nnz2 = detect_only(reads, budget_for(reads, PP.SPLIT_BYTES),
                                   "wide split", state)
    info = state["detect"]["wide split"]
    ok = (info["rung"] == "split" and info["peak_over_budget"] <= 1
          and (nk2, nnz2) == (nk, nnz) and same_pairs(split, res.pairs))
    print(f"wide on the fused split path ({info['peak_over_budget']:.3f} "
          f"of the budget) equal to the single pass: {ok}")
    if not ok:
        raise AssertionError("wide: the split path differs")
    staged, nk3, nnz3 = detect_only(
        reads, budget_for(reads, PP.STAGED_BYTES), "wide staged", state)
    info = state["detect"]["wide staged"]
    ok = (info["rung"] == "staged" and info["peak_over_budget"] <= 1
          and (nk3, nnz3) == (nk, nnz) and same_pairs(staged, res.pairs))
    print(f"wide on the staged chain at {PP.STAGED_BYTES} B/base "
          f"({info['peak_over_budget']:.3f} of the budget) equal to the "
          f"single pass: {ok}")
    if not ok:
        raise AssertionError("wide: the staged chain differs")


def phase_ultralong(state: dict) -> None:
    """The unpacked branch end to end: reads over 65,535 bp."""
    from bella_tpu_torch.io.simulate import random_genome, sample_reads

    t0 = time.perf_counter()
    g = random_genome(2_000_000, seed=601)
    reads, _ = sample_reads(g, 1_333, mean_len=30_000, min_len=5_000,
                            error_rate=0.15, seed=602, circular=False)
    lens = reads.lengths
    print(f"ultralong corpus: {reads.num_reads} reads, {int(lens.sum())} "
          f"bases, {int((lens > 0xFFFF).sum())} over 65,535 bp (longest "
          f"{int(lens.max())}), made in {time.perf_counter() - t0:.1f} s")
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.overlap import pairs as PP

    if PP.detection_rung(reads, BellaConfig()) != "unpacked":
        raise AssertionError("the ultralong corpus does not take the "
                             "unpacked branch")
    res = corpus_run(reads, "ultralong", ULTRALONG_ANCHORS, state)
    far = max(int(res.pairs.pos_h.max()), int(res.pairs.pos_v.max()))
    print(f"ultralong: furthest seed position {far}")
    if far <= 0xFFFF:
        raise AssertionError("ultralong: no seed beyond 16-bit positions")


def mode_run(reads, kw: dict, label: str, state: dict, truth):
    """One mode on the main path: its pair invariants, K1 launched, under
    --selfcheck the host recount equal to the card's counts and the K1
    against K2 check run (it raises on failure), and its anchors."""
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.overlap import pairs as PP

    cfg = BellaConfig(**kw)
    res, counts = run_main(reads, cfg, label, state, truth=truth)
    check_pairs(res.pairs, cfg.kmer_size, label)
    info = state["runs"][label]
    checks = info["checks"]
    if counts["xdrop_static"] <= 0:
        raise AssertionError(f"{label}: the main path launched no K1")
    if cfg.selfcheck:
        if checks.get("host_reliable_stats") != [[res.num_kmers, res.nnz]]:
            raise AssertionError(f"{label}: the host recount "
                                 f"{checks.get('host_reliable_stats')} is "
                                 f"not the card's {res.num_kmers}/{res.nnz}")
        if not checks.get("_align_check") or counts["xdrop_adaptive"] <= 0:
            raise AssertionError(f"{label}: K1 was not held against K2")
    got = dict(nnz=info["nnz"], pairs=info["pairs"], rows=info["passed"],
               levels=[list(x) for x in info["levels"]],
               tail_pairs=info["tail_pairs"])
    ms = info["kernel_ms"]
    print(f"{label}: nnzA {res.nnz}, {res.pairs.num_pairs} pairs, "
          f"{res.num_output} rows, cascade {got['levels']}, tail "
          f"{got['tail_pairs']}; K1 {ms.get('xdrop_static', 0.0):.1f} ms "
          f"({counts['xdrop_static']} launches), K2 "
          f"{ms.get('xdrop_adaptive', 0.0):.1f} ms "
          f"({counts['xdrop_adaptive']}); wall {info['wall_s']:.2f} s, peak "
          f"{info['peak_mem_bytes'] / 1e9:.2f} GB; RC "
          f"{info.get('recall', 0):.2f} PR {info.get('precision', 0):.2f}; "
          f"bounds {info['bounds']}, rung {PP.detection_rung(reads, cfg)}; "
          f"checks {json.dumps(checks)}; ops (ms) "
          + json.dumps({k: round(v, 3) for k, v in info["op_ms"].items()}),
          flush=True)
    want = MODE_ANCHORS.get(label)
    if want is not None and got != want:
        raise AssertionError(f"{label} anchors differ: got {got}, want {want}")
    return res


def numpy_hash64(x: np.ndarray) -> np.ndarray:
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(0xFF51AFD7ED558CCD)
    x = x ^ (x >> np.uint64(33))
    x = x * np.uint64(0xC4CEB9FE1A85EC53)
    return x ^ (x >> np.uint64(33))


def numpy_masks(reads, n_reads: int, k: int, w: int, s: int):
    """Minimizer (window w) and syncmer (s-mers of length s) masks of the
    k-mer positions of the first n_reads reads, one read at a time in
    plain numpy: the canonical k-mer packed from its window, the window's
    least hash64 taking the rightmost of ties, the s-mers cut from the
    canonical k-mer. Positions whose k-mer runs past the read end are
    False."""
    from numpy.lib.stride_tricks import sliding_window_view as windows

    off = reads.offsets
    total = int(off[n_reads])
    mini = np.zeros(total - k + 1, bool)
    sync = np.zeros(total - k + 1, bool)
    big = np.uint64(2**64 - 1)
    for r in range(n_reads):
        seq = reads.codes[off[r]:off[r + 1]].astype(np.uint64)
        n = len(seq) - k + 1
        if n <= 0:
            continue
        win = windows(seq, k)
        fwd = np.zeros(n, np.uint64)
        rc = np.zeros(n, np.uint64)
        for i in range(k):
            fwd = (fwd << np.uint64(2)) | win[:, i]
            rc = (rc << np.uint64(2)) | (np.uint64(3) - win[:, k - 1 - i])
        canon = np.minimum(fwd, rc)
        key = numpy_hash64(canon)
        padded = np.concatenate([np.full(w - 1, big, np.uint64), key])
        back = windows(padded, w)[:, ::-1]
        winner = np.arange(n) - np.argmin(back, axis=1)
        mini[off[r] + winner] = True
        smer = [numpy_hash64((canon >> np.uint64(2 * (k - s - i)))
                             & np.uint64((1 << (2 * s)) - 1))
                for i in range(k - s + 1)]
        inner = np.minimum.reduce(smer[1:-1])
        sync[off[r]:off[r] + n] = ~((inner < smer[0]) & (inner < smer[-1]))
    return mini, sync


def check_masks(reads, n_reads: int = 2000) -> None:
    """The card's minimizer (-w 7) and syncmer masks of the first n_reads
    reads of a corpus against numpy_masks."""
    import torch

    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.fastq import ReadSet
    from bella_tpu_torch.kmers import count, select

    off = reads.offsets
    sub = ReadSet(list(reads.names[:n_reads]), reads.codes[:off[n_reads]],
                  off[:n_reads + 1].copy())
    cfg = BellaConfig(window_len=7)
    occ = count.extract_occurrences(sub, cfg)
    got_m = select.minimizer_mask(occ, 7).cpu().numpy()
    got_s = select.syncmer_mask(occ, sub, BellaConfig(use_syncmer=True))
    got_s = got_s.cpu().numpy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    want_m, want_s = numpy_masks(sub, n_reads, cfg.kmer_size, 7,
                                 cfg.smer_len)
    print(f"masks of {n_reads} reads ({len(got_m)} positions): minimizers "
          f"{int(got_m.sum())} == numpy loop: "
          f"{np.array_equal(got_m, want_m)}; syncmers {int(got_s.sum())} "
          f"== numpy loop: {np.array_equal(got_s, want_s)} (numpy "
          f"{time.perf_counter() - t0:.1f} s)")
    if not (np.array_equal(got_m, want_m) and np.array_equal(got_s, want_s)):
        raise AssertionError("a selection mask differs from the numpy loop")


def phase_modes(state: dict) -> None:
    """Dataset D in every detection mode of the slice, then a checkpoint
    saved and resumed; the masks against a numpy loop."""
    from bella_tpu_torch.config import BellaConfig

    reads, truth = state["demo_reads"], state["demo_truth"]
    print(f"demo at the default config: " + json.dumps(
        score_rows(state["demo_rows"], truth, False, state["work"])))
    for label, kw in MODES:
        res = mode_run(reads, kw, label, state, truth)
        if label == "demo -w 7":
            state["w7_result"] = res
        if label == "demo --selfcheck" and (
                res.nnz != DEMO_ANCHORS["nnz"]
                or res.rows != state["demo_rows"]):
            raise AssertionError("--selfcheck changed the demo's output")
        if label == "demo --auto-bounds":
            print(f"demo --auto-bounds: estimated coverage "
                  f"{state['runs'][label]['checks']['estimate_coverage']}, "
                  f"bounds {state['runs'][label]['bounds']}")
    ck = os.path.join(state["work"], "demo_triples.npz")
    saved = mode_run(reads, dict(checkpoint=ck), "demo --checkpoint (save)",
                     state, truth)
    resumed = mode_run(reads, dict(checkpoint=ck),
                       "demo --checkpoint (resume)", state, truth)
    phases = [state["runs"][f"demo --checkpoint ({x})"]["phase_s"]
              for x in ("save", "resume")]
    ok = ("kmerCounting" in phases[0] and "kmerCounting" not in phases[1]
          and saved.rows == resumed.rows == state["demo_rows"])
    print(f"checkpoint of {os.path.getsize(ck)} bytes: the resumed run "
          f"skipped counting and both give the demo's "
          f"{DEMO_ANCHORS['rows']} rows: {ok}")
    if not ok:
        raise AssertionError("checkpoint resume differs")
    check_masks(reads)


def phase_hifi(state: dict) -> None:
    """A HiFi corpus on dataset D's genome, under --auto-bounds."""
    from bella_tpu_torch.io.simulate import sample_reads

    t0 = time.perf_counter()
    reads, truth = sample_reads(state["demo_genome"], 7_700, mean_len=6000,
                                min_len=1000, error_rate=0.005, seed=403,
                                circular=False)
    print(f"hifi corpus: {reads.num_reads} reads, {int(reads.lengths.sum())} "
          f"bases, made in {time.perf_counter() - t0:.1f} s")
    for label, kw in HIFI_MODES:
        mode_run(reads, kw, label, state, truth)
        print(f"{label}: estimated coverage "
              f"{state['runs'][label]['checks']['estimate_coverage']}, "
              f"bounds {state['runs'][label]['bounds']}")


# ----------------------------------------------------------------------
# several shards: in one process, across processes; SpGEMM; native I/O
# ----------------------------------------------------------------------


def shard_group(n: int):
    """n shards: one a card when n cards are visible, else n on cuda:0
    (an explicit repeated-device group)."""
    import torch

    from bella_tpu_torch.parallel import make_mesh

    if torch.cuda.device_count() >= n:
        return make_mesh(n)
    return make_mesh(devices=["cuda:0"] * n)


def rows_digest(rows) -> str:
    """Hash of the rows, sorted: equal for the same rows in any order."""
    import hashlib

    h = hashlib.sha256()
    for r in sorted(rows):
        h.update(r.encode())
    return h.hexdigest()


def sharded_run(reads, kw: dict, label: str, state: dict, single):
    """The main path over four shards: its rows, pairs, counts and
    cascade equal the single-device run's, K1 ran on every shard."""
    from bella_tpu_torch.config import BellaConfig

    mesh = shard_group(4)
    res, counts = run_main(reads, BellaConfig(devices=4, **kw), label, state,
                           mesh=mesh)
    info = state["runs"][label]
    one = state["runs"][single]
    shards = {k for k, v in info["kernel_by_shard"].items()
              if k.startswith("xdrop_static") and v["launches"] > 0}
    same = dict(
        nnz=info["nnz"] == one["nnz"], pairs=info["pairs"] == one["pairs"],
        rows=info["passed"] == one["passed"],
        levels=info["levels"] == one["levels"],
        tail=info["tail_pairs"] == one["tail_pairs"],
        k1_on_every_shard=len(shards) == 4)
    print(f"{label} over {mesh.describe()}: nnzA {info['nnz']}, "
          f"{info['pairs']} pairs, {info['passed']} rows, cascade "
          f"{info['levels']}, tail {info['tail_pairs']}; wall "
          f"{info['wall_s']:.2f} s (single device "
          f"{one['wall_s']:.2f} s); K1 by shard "
          + json.dumps(info["kernel_by_shard"]) + f"; exchange "
          f"{info['exchange_bytes']} bytes in {info['exchange_s']:.3f} s; "
          "peak by device " + json.dumps(info["peak_mem_bytes_by_device"])
          + "; equal to the single device: " + json.dumps(same), flush=True)
    if not all(same.values()) or counts["xdrop_static"] <= 0:
        raise AssertionError(f"{label} differs from {single}: {same}")
    return res


def phase_multidev(state: dict) -> None:
    """Four shards (one a card, or four on cuda:0): dataset D through the
    fused branch and with -w 7 through the modular one, each equal to its
    single-device run; the wide corpus's detection (the wide-id row
    layout) and the bench corpus's at two shards with the wide layout
    forced, each equal to its single pass."""
    import torch

    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.parallel import detect_overlaps_sharded

    reads = state["demo_reads"]
    res = sharded_run(reads, {}, "demo, 4 shards", state, "demo")
    ok = (same_pairs(res.pairs, state["demo_pairs"])
          and rows_digest(res.rows) == rows_digest(state["demo_rows"]))
    print(f"demo, 4 shards: pairs field for field and the {res.num_output} "
          f"rows (sorted, by hash) equal the demo's: {ok}; in the same "
          f"order: {res.rows == state['demo_rows']}")
    if not ok:
        raise AssertionError("demo over 4 shards differs")
    w7 = state["w7_result"]
    res = sharded_run(reads, dict(window_len=7), "demo -w 7, 4 shards", state,
                      "demo -w 7")
    ok = same_pairs(res.pairs, w7.pairs) and res.rows == w7.rows
    print(f"demo -w 7, 4 shards (sharded_candidates): equal to -w 7 on one "
          f"device: {ok}")
    if not ok:
        raise AssertionError("-w 7 over 4 shards differs")
    del res
    for label, corpus, n, wide, (single, nk, nnz) in (
            ("wide, 4 shards", state["wide"][0], 4, False, state["wide"][1:]),
            ("bench, 2 shards, wide layout", state["bench_reads"], 2, True,
             (state["bench_result"].pairs, None, BENCH_ANCHORS["nnz"]))):
        mesh = shard_group(n)
        for d in cards(mesh):
            torch.cuda.synchronize(d)
            torch.cuda.reset_peak_memory_stats(d)
        t0 = time.perf_counter()
        got, nk2, nnz2 = detect_overlaps_sharded(corpus, BellaConfig(), mesh,
                                                 force_wide=wide)
        for d in cards(mesh):
            torch.cuda.synchronize(d)
        info = dict(label=label, shards=mesh.describe(),
                    seconds=time.perf_counter() - t0, num_kmers=nk2,
                    nnz=nnz2, pairs=got.num_pairs,
                    exchange_bytes=mesh.exchange_bytes,
                    exchange_s=mesh.exchange_seconds,
                    peak_mem_bytes_by_device={
                        str(d): int(torch.cuda.max_memory_allocated(d))
                        for d in cards(mesh)})
        print("detection " + json.dumps(info), flush=True)
        state.setdefault("detect", {})[label] = info
        ok = (nnz2 == nnz and (nk is None or nk2 == nk)
              and same_pairs(got, single))
        print(f"{label}: nnzA {nnz2}, {got.num_pairs} pairs, equal to the "
              f"single pass field for field: {ok}")
        if not ok:
            raise AssertionError(f"{label} differs from the single pass")


def dist_worker(rank: int, port: str, out: str, backend: str) -> int:
    """One rank of the multiproc phase: init_distributed from torchrun's
    variables, then detect_overlaps_sharded on the bench corpus; rank 0
    saves the pairs and its numbers to `out`."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=port)
    import torch
    import torch.distributed as dist

    from bench_torch import bench_corpus
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.parallel import (
        detect_overlaps_sharded, init_distributed,
    )

    group = init_distributed(device="cuda" if backend == "nccl" else
                             "cuda:0", backend=backend)
    probe = None
    if backend == "gloo":
        # does this torch's gloo take CUDA tensors in all_to_all? (the
        # group stages through the host either way)
        x = torch.arange(2, device=group.devices[0])
        try:
            dist.all_to_all_single(torch.empty_like(x), x)
            probe = "gloo all_to_all_single carries CUDA tensors"
        except (RuntimeError, ValueError) as e:
            probe = (f"gloo all_to_all_single refuses CUDA tensors: "
                     f"{type(e).__name__}: {str(e).splitlines()[0][:200]}")
        dist.barrier()
    reads = bench_corpus()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pairs, nk, nnz = detect_overlaps_sharded(reads, BellaConfig(), group)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    if rank == 0:
        import dataclasses

        np.savez(out, num_kmers=nk, nnz=nnz, seconds=secs,
                 exchange_bytes=group.exchange_bytes,
                 exchange_s=group.exchange_seconds,
                 device=str(group.devices[0]), probe=str(probe),
                 **{f.name: getattr(pairs, f.name)
                    for f in dataclasses.fields(pairs)})
    dist.destroy_process_group()
    print(f"rank {rank} on {group.devices[0]} ({backend}): "
          f"{pairs.num_pairs} pairs in {secs:.3f} s", flush=True)
    return 0


def phase_multiproc(state: dict) -> None:
    """Two processes started with torchrun's variables run
    init_distributed and detect_overlaps_sharded on the bench corpus:
    NCCL with one card a rank where two cards are visible, else gloo with
    both ranks on cuda:0. Rank 0's pairs equal the single-device run's;
    a rank that fails fails the phase."""
    import socket

    import torch

    from bella_tpu_torch.overlap.pairs import CandidatePairs

    backend = "nccl" if torch.cuda.device_count() >= 2 else "gloo"
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = str(sock.getsockname()[1])
    out = os.path.join(state["work"], "multiproc.npz")
    here = os.path.dirname(os.path.abspath(__file__))
    env = dict(os.environ, PYTHONPATH=here)
    t0 = time.perf_counter()
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--dist-worker", str(r),
         port, out, backend], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(timeout=300)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for r, (p, log) in enumerate(zip(procs, logs)):
        print(f"multiproc rank {r} exit {p.returncode}: "
              f"{log.strip().splitlines()[-1] if log.strip() else ''}")
        if p.returncode != 0:
            print(log[-3000:])
            raise AssertionError(f"multiproc rank {r} failed")
    d = np.load(out)
    got = CandidatePairs(*(d[f] for f in (
        "read_h", "read_v", "pos_h", "pos_v", "count", "matches",
        "overlap_est", "seed_rc")))
    info = dict(backend=backend, ranks=2, device_rank0=str(d["device"]),
                layout=("one card a rank" if backend == "nccl" else
                        "both ranks on cuda:0, exchanged through the host"),
                gloo_cuda_probe=str(d["probe"]), nnz=int(d["nnz"]),
                num_kmers=int(d["num_kmers"]), pairs=got.num_pairs,
                detect_s=float(d["seconds"]),
                exchange_bytes=int(d["exchange_bytes"]),
                exchange_s=float(d["exchange_s"]),
                phase_s=time.perf_counter() - t0)
    print("multiproc " + json.dumps(info), flush=True)
    state["multiproc"] = info
    ok = (info["nnz"] == BENCH_ANCHORS["nnz"]
          and got.num_pairs == BENCH_ANCHORS["pairs"]
          and same_pairs(got, state["bench_result"].pairs))
    print(f"multiproc ({backend}): nnzA {info['nnz']}, {got.num_pairs} "
          f"pairs, equal to the single-device run: {ok}")
    if not ok:
        raise AssertionError("multiproc pairs differ")


def phase_spgemm(state: dict) -> None:
    """C = A A on the card for an R-MAT matrix (scale 14, edge factor 8,
    seed 0), equal to scipy.sparse's product; ms, flops/s, nnz(C)/s."""
    import scipy.sparse as sp
    import torch

    from bella_tpu_torch.sparse import csc_from_triples, rmat_triples
    from bella_tpu_torch.sparse.spgemm import spgemm, symbolic

    r, c = rmat_triples(14, 8, seed=0)
    n = 1 << 14
    a = csc_from_triples(r, c, np.ones(len(r)), n, n)
    flops = int(symbolic(a, a).sum())
    spgemm(a, a)  # warm-up
    times = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        got = spgemm(a, a)  # returns host arrays: synchronized
        times.append(1e3 * (time.perf_counter() - t0))
    ms = float(np.median(times))
    m = sp.csc_matrix((np.ones(a.nnz), a.rowids, a.colptr), (n, n))
    t0 = time.perf_counter()
    ref = (m @ m).tocsc()
    ref.sort_indices()
    scipy_ms = 1e3 * (time.perf_counter() - t0)
    ok = (np.array_equal(got.colptr, ref.indptr)
          and np.array_equal(got.rowids, ref.indices)
          and np.array_equal(got.values, ref.data))
    info = dict(device="cuda:0", scale=14, edge_factor=8, a_nnz=a.nnz,
                c_nnz=got.nnz,
                flops=flops, ms=ms, ms_runs=times,
                flops_per_s=flops / (ms / 1e3),
                nnz_c_per_s=got.nnz / (ms / 1e3), scipy_host_ms=scipy_ms,
                equal_to_scipy=ok)
    print("spgemm " + json.dumps(info), flush=True)
    state["spgemm"] = info
    if not ok:
        raise AssertionError("SpGEMM differs from scipy.sparse")


def phase_native(state: dict) -> None:
    """Dataset D as a FASTQ file: the native parse equals the numpy
    parse; run_files on it (native parse, native M4 writer) writes the
    demo's rows byte for byte."""
    from bella_tpu_torch.align import _build
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.fastq import parse_fastq
    from bella_tpu_torch.io.simulate import write_fastq
    from bella_tpu_torch.pipeline import run_files
    from bella_tpu_torch.utils import log as ulog

    from bella_tpu_torch import native

    reads = state["demo_reads"]
    path = os.path.join(state["work"], "demo.fastq")
    t0 = time.perf_counter()
    native.get_lib()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    write_fastq(path, reads)
    write_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    nat = parse_fastq(path)
    native_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    ref = parse_fastq(path, native=False)
    numpy_s = time.perf_counter() - t0
    # the native parser's threads add the error sum in another order
    same = dict(names=nat.names == ref.names == reads.names,
                codes=np.array_equal(nat.codes, ref.codes),
                offsets=np.array_equal(nat.offsets, ref.offsets),
                err_bases=nat.err_bases == ref.err_bases,
                err_sum=abs(nat.err_sum - ref.err_sum)
                <= 1e-9 * max(ref.err_sum, 1.0))
    print(f"native library built in {build_s:.1f} s; native parse of "
          f"{os.path.getsize(path)} bytes ({write_s:.1f} s to write): "
          f"{native_s:.3f} s, numpy {numpy_s:.3f} s; equal: "
          + json.dumps(same), flush=True)
    del ref
    if not all(same.values()):
        raise AssertionError("the native parse differs from numpy's")
    out = os.path.join(state["work"], "demo_native.out")
    ulog.reset()
    t0 = time.perf_counter()
    res = run_files(path, BellaConfig(), out)
    wall = time.perf_counter() - t0
    secs = dict(ulog.PHASE_SECONDS)
    launches = _build.launches()
    with open(out, "rb") as f:
        got = f.read()
    ok = (got == "".join(state["demo_rows"]).encode()
          and res.num_output == DEMO_ANCHORS["rows"]
          and launches["xdrop_static"] > 0 and not launches["ext_prep"])
    info = dict(device="cuda:0", bytes=len(got), rows=res.num_output,
                wall_s=wall,
                build_s=build_s, fastq_bytes=os.path.getsize(path),
                phase_s=secs, parse_native_s=native_s, parse_numpy_s=numpy_s,
                outputting_native_s=secs.get("outputting"),
                outputting_python_s=state["runs"]["demo"]["phase_s"].get(
                    "outputting"),
                launches=launches)
    print("native " + json.dumps(info), flush=True)
    state["native"] = info
    print(f"run_files with the native parser and writer: {res.num_output} "
          f"rows, byte-identical to the Python rows: {ok}")
    if not ok:
        raise AssertionError("native rows differ from the Python rows")


def _tool_bench(out: dict, backend: str) -> list:
    """What bench_torch.py's last line misses of its contract on the bench
    corpus."""
    from bench_torch import BENCH_ANCHORS as WANT

    bad = [k for k in ("metric", "value", "unit", "vs_baseline", "samples",
                       "align_value", "align_unit", "align_vs_baseline",
                       "align_samples", "device") if k not in out]
    if (len(out.get("samples", ())), len(out.get("align_samples", ()))) != (
            5, 3):
        bad.append("samples: not 5 and 3")
    if not out.get("device", {}).get("power_limit"):
        bad.append("device: no power limit")
    want = dict(WANT[backend])
    if backend == "static":  # and this script's own record of them
        want.update(nnzA=BENCH_ANCHORS["nnz"], pairs=BENCH_ANCHORS["pairs"],
                    aligned_bases=BENCH_ANCHORS["aligned"],
                    passed=BENCH_ANCHORS["passed"],
                    cascade=[list(x) for x in BENCH_ANCHORS["levels"]])
    bad += [f"{k}: {out.get(k)} != {v}" for k, v in want.items()
            if out.get(k) != v]
    return bad


def _tool_profile(out: dict) -> list:
    want = BENCH_ANCHORS
    bad = [] if out["same_as_plain"] else ["split run differs from plain"]
    got = (out["nnzA"], out["pairs"], out["aligned_bases"],
           [tuple(x) for x in out["cascade"]])
    if got != (want["nnz"], want["pairs"], want["aligned"],
               list(want["levels"])):
        bad.append(f"anchors: {got}")
    if out["timeline"] != "card" or not all(out["within_5pct"].values()):
        bad.append("the card's parts miss the runs' clocks by over 5 %")
    if not out["kernel_event_ms"].get("xdrop_static") or not out["host_syncs"]:
        bad.append("no K1 events or no host syncs counted")
    if not out.get("trace", {}).get("top_ops"):
        bad.append("no trace")
    return bad


def _tool_align_bench(out: dict) -> list:
    bad = []
    for name in ("static", "adaptive"):
        r = out.get(name) or {}
        if not r.get("bases_per_s", 0) > 0 or len(r.get("ms_samples", ())) < 2:
            bad.append(f"{name}: no rate")
    return bad


def _tool_detect(out: dict) -> list:
    return [] if (out["anchors"] == "held" and out["same_as_detect_overlaps"]
                  and out["stage_s"]) else ["stages or anchors"]


def _tool_weak(out: dict) -> list:
    groups = {g["shards"]: g for g in out["groups"]}
    bad = [] if set(groups) == {1, 2} else [f"groups {sorted(groups)}"]
    bad += [f"{n} shards" for n, g in groups.items()
            if not g["same_as_one_device"]
            or g["routed_bytes"] != g["group_bytes"]]
    if groups.get(2, {}).get("routed_bytes", 0) <= 0:
        bad.append("nothing routed over 2 shards")
    if "functional" not in out["label"]:
        bad.append("unlabelled")
    return bad


def _script(name: str):
    """The module of scripts/<name>.py (for its anchors)."""
    import importlib.util

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "scripts", name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tool_predict(out: dict) -> list:
    """The drift predictor's A/B on the bench corpus: both runs keep the
    bench's pairs, the predictor-on run its aligned bases and passed."""
    bad = [] if out["anchors"] == "held" else ["anchors"]
    bad += [f"{label}: {out[label]['pairs']} pairs" for label in ("on", "off")
            if out[label]["pairs"] != BENCH_ANCHORS["pairs"]]
    if (out["on"]["aligned_bases"], out["on"]["passed"]) != (
            BENCH_ANCHORS["aligned"], BENCH_ANCHORS["passed"]):
        bad.append("on: aligned bases or passed")
    if [len(out[x]["samples_s"]) for x in ("on", "off")] != [3, 3]:
        bad.append("samples: not 3 each")
    return bad


def _tool_repeats(out: dict, backend: str) -> list:
    want = _script("torch_crossval_repeats").REPEAT_ANCHORS[backend]
    bad = [] if out["anchors"] == "held" else ["anchors"]
    bad += [f"{k}: {out.get(k)} != {v}" for k, v in want.items()
            if out.get(k) != v]
    if not 0 < out["port"]["rc"] <= 100:
        bad.append("no recall")
    return bad


def _tool_recall(out: dict) -> list:
    """The recall probe at the bench's genome, where its corpus is the
    bench corpus."""
    bad = [] if out["anchors"] == "held" else ["anchors"]
    if (out["nnzA"], out["pairs"]) != (BENCH_ANCHORS["nnz"],
                                       BENCH_ANCHORS["pairs"]):
        bad.append(f"nnzA, pairs: {out['nnzA']}, {out['pairs']}")
    if not 0 < out["rc"] <= 100:
        bad.append("no recall")
    return bad


def _tool_split(out: dict) -> list:
    bad = [] if out["parity"] else ["differs from the single pass"]
    if (out["passes"], out["groups"]) != (4, 2):
        bad.append(f"{out['passes']} passes in {out['groups']} groups")
    return bad


# the measurement tools and the ported scripts as a user runs them: (label,
# arguments, extra environment, check of the last line giving what it
# misses). "{work}" is the phase's work directory. The bench tools and the
# predictor A/B run on the bench corpus, the recall probe at the bench's
# genome (its corpus there), the split probe at its own size (51 Mbp of
# reads: phase 8 runs dataset D through the split path, but neither with
# force_group nor with the staged chain)
TOOLS = (
    ("bench_torch.py", ["bench_torch.py"], {},
     lambda out: _tool_bench(out, "static")),
    ("bench_torch.py --backend jax", ["bench_torch.py", "--backend", "jax"],
     {}, lambda out: _tool_bench(out, "jax")),
    ("torch_align_profile.py", ["scripts/torch_align_profile.py"], {},
     _tool_profile),
    ("torch_align_bench.py --pairs 1024",
     ["scripts/torch_align_bench.py", "--pairs", "1024"], {},
     _tool_align_bench),
    ("torch_detect_profile.py", ["scripts/torch_detect_profile.py"], {},
     _tool_detect),
    ("torch_weak_scaling.py --max-shards 2",
     ["scripts/torch_weak_scaling.py", "--max-shards", "2"], {}, _tool_weak),
    ("torch_rescue_predict_probe.py (bench corpus)",
     ["scripts/torch_rescue_predict_probe.py"],
     dict(BELLA_BENCH_GENOME="300000"), _tool_predict),
    ("torch_crossval_repeats.py", ["scripts/torch_crossval_repeats.py",
                                   "{work}"], {},
     lambda out: _tool_repeats(out, "static")),
    ("torch_crossval_repeats.py --backend jax",
     ["scripts/torch_crossval_repeats.py", "--backend", "jax"], {},
     lambda out: _tool_repeats(out, "jax")),
    ("torch_detect_recall_probe.py --genome 300000",
     ["scripts/torch_detect_recall_probe.py", "--genome", "300000"], {},
     _tool_recall),
    ("torch_split_group_probe.py", ["scripts/torch_split_group_probe.py"],
     {}, _tool_split),
)
CSV_HEADER = "k,window,lower,upper,xdrop,error,nkmer,seconds,recall,precision,f1"


def _shell_driver(here: str, work: str, env: dict, want: dict) -> list:
    """scripts/torch_run_pipeline.sh on the repeat corpus that
    torch_crossval_repeats.py left in `work`: exit 0, one CSV row under
    the header, and the recall and precision of the script's static run
    (`want`, its last line): the CLI writes the same rows."""
    csv = os.path.join(work, "results.csv")
    r = subprocess.run(
        ["bash", "scripts/torch_run_pipeline.sh", "-f",
         os.path.join(work, "rep.fofn"), "-G", os.path.join(work, "rep.truth"),
         "-o", os.path.join(work, "shell"), "--csv", csv], cwd=here,
        env=env, capture_output=True, text=True, timeout=600)
    if r.returncode:
        return [f"exit {r.returncode}: {r.stderr[-2000:]}"]
    with open(csv) as f:
        lines = f.read().splitlines()
    print(f"tool torch_run_pipeline.sh: {r.stdout.strip()}; csv {lines}",
          flush=True)
    if len(lines) != 2 or lines[0] != CSV_HEADER:
        return [f"csv {lines}"]
    row = dict(zip(CSV_HEADER.split(","), lines[1].split(",")))
    got = (row["recall"], row["precision"])
    port = want.get("port", {})
    exp = (f"{port.get('rc', -1):.2f}", f"{port.get('pr', -1):.2f}")
    return [] if got == exp else [f"recall, precision {got} != {exp}"]


def phase_tools(state: dict) -> None:
    """Each measurement tool and ported script in a subprocess, as a user
    runs it: it exits 0 and its last line keeps its contract; then the
    shell driver on the repeat corpus."""
    here = os.path.dirname(os.path.abspath(__file__))
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("BELLA_BENCH_")}
    work = os.path.join(state["work"], "tools")
    os.makedirs(work, exist_ok=True)
    bad, outs = {}, {}
    for label, args, extra, check in TOOLS:
        t0 = time.perf_counter()
        r = subprocess.run(
            [sys.executable] + [a.format(work=work) for a in args], cwd=here,
            env=dict(env, **extra), capture_output=True, text=True,
            timeout=600)
        lines = r.stdout.strip().splitlines()
        try:
            out = json.loads(lines[-1]) if lines else {}
            miss = ([f"exit {r.returncode}"] if r.returncode else []) + (
                check(out) if out else ["no output"])
        except (ValueError, KeyError, TypeError) as e:
            out, miss = {}, [f"last line unreadable: {e!r}"]
        print(f"tool {label}: {time.perf_counter() - t0:.1f} s, "
              + ("ok" if not miss else f"FAILED {miss}"), flush=True)
        print(f"tool {label} " + json.dumps(out), flush=True)
        outs[label] = out
        if miss:
            print(r.stderr[-4000:], file=sys.stderr)
            bad[label] = miss
    t0 = time.perf_counter()
    miss = _shell_driver(here, work, env, outs["torch_crossval_repeats.py"])
    print(f"tool torch_run_pipeline.sh: {time.perf_counter() - t0:.1f} s, "
          + ("ok" if not miss else f"FAILED {miss}"), flush=True)
    if miss:
        bad["torch_run_pipeline.sh"] = miss
    state["tools"] = bad
    if bad:
        raise AssertionError(f"measurement tools failed: {bad}")


def _batches(state: dict, sel):
    """The kernel inputs the bench main path builds for pairs `sel`."""
    from bella_tpu_torch.align import xdrop as X
    from bella_tpu_torch.config import BellaConfig

    reads = state["bench_reads"]
    pairs = state["bench_result"].pairs
    cfg = BellaConfig()
    rd = X._upload_reads(reads, "cuda")
    lens = reads.lengths
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    return [
        (e["T"], e["t_len"], e["Q"], e["q_len"], e["L"])
        for _, e in X.extension_batches(rd, pairs, sel, pair_len,
                                        cfg.kmer_size, cfg.align_batch)
    ]


def _bound_parts(T, Q, steps, W: int) -> tuple:
    """(bytes, operations) of one launch: the words and lengths read, the
    three result rows written; OPS_PER_CELL a band cell over the
    antidiagonals run."""
    B = T.shape[0]
    return (4 * (T.numel() + Q.numel()) + 4 * 2 * B + 4 * 3 * B,
            OPS_PER_CELL * W * int(steps.sum()))


def stream_bytes(reads, extensions: int) -> int:
    """Bytes a descriptor-fed launch reads and writes at least: the reads'
    packed words once; each extension's two descriptors and two lengths,
    and its three result rows."""
    return (4 * int((-(-reads.lengths.astype(np.int64) // 16)).sum())
            + (2 * 8 + 2 * 4 + 3 * 4) * extensions)


def _bound_of(byts: int, ops: int) -> tuple:
    """(ms, what binds) of the larger of bytes at the memory rate and
    operations at the peak rate."""
    t_b, t_o = byts / HBM_BYTES_PER_S, ops / OPS_PER_S
    return 1e3 * max(t_b, t_o), "bytes" if t_b >= t_o else "operations"


def _bound_ms(batches, steps, W: int) -> tuple:
    parts = [_bound_parts(T, Q, s, W)
             for (T, _, Q, _, _), s in zip(batches, steps)]
    return _bound_of(sum(p[0] for p in parts), sum(p[1] for p in parts))


def prep_bound(calls) -> tuple:
    """(ms, what binds) of the least time of the prep launches `calls`:
    every output (T and Q words, lengths, seed ends) written once; the
    pair block, and the length, word offset and words of each distinct
    read of the batch, read once; PREP_OPS_PER_WORD a word written."""
    lens, byts, words = {}, 0, 0
    for rd, blk, _, L in calls:
        ids = np.unique(blk[:2].cpu().numpy())
        n = lens.setdefault(id(rd), rd.lens.cpu().numpy())[ids]
        B, Wp = blk.shape[1], L // 16
        byts += (4 * 4 * B * Wp + 4 * 4 * B + 4 * 2 * B + 4 * 5 * B
                 + 2 * 8 * len(ids) + 4 * int((-(-n // 16)).sum()))
        words += 4 * B * Wp
    return _bound_of(byts, PREP_OPS_PER_WORD * words)


def list_span(steps, slots: int) -> float:
    """Span, in steps, of running extensions of `steps` antidiagonals in
    the given order on `slots` workers that each take the next extension
    as soon as they free (greedy list scheduling)."""
    free = [0] * max(1, min(slots, len(steps)))
    end = 0
    for s in steps:
        t = heapq.heappop(free) + int(s)
        end = max(end, t)
        heapq.heappush(free, t)
    return float(end)


def tail_ratio(steps, slots: int) -> float:
    """A launch's span over the span it would have if every extension
    took the launch's mean step count, both as list_span models them."""
    n = len(steps)
    even = -(-n // slots) * float(np.mean(steps)) if n else 0.0
    return list_span(steps, slots) / even if even else 1.0


def phase_table(state: dict) -> list:
    import torch

    from bella_tpu_torch.align import pallas_xdrop as P
    from bella_tpu_torch.align import xdrop as X
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.utils.measure import cuda_ms

    cfg = BellaConfig()
    rows = []
    # K1: the bench main path's first pass (every pair, W = pallas_band),
    # as the path runs it: one descriptor-fed launch
    reads = state["bench_reads"]
    pairs = state["bench_result"].pairs
    P_ = pairs.num_pairs
    rd = X._upload_reads(reads, "cuda")
    lens = reads.lengths
    longest = int(np.maximum(lens[pairs.read_h], lens[pairs.read_v]).max())
    ext = X.extension_streams(rd, X._pair_block(pairs, np.arange(P_),
                                                "cuda"), cfg.kmer_size)
    W1 = P.round_band(cfg.pallas_band)

    def k1(with_steps=False):
        return P.run_streams(ext["T"], ext["Q"], cfg.xdrop, W1, P.NO_CAP,
                             False, longest=longest, with_steps=with_steps)

    ms1 = cuda_ms(k1)
    out1 = k1(True)
    # the same launch on a sample of the pass (its longest pairs and
    # random others, both strands, so every kind of descriptor) against
    # the plain version of the streams gathered from the reads' words
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    rng = np.random.default_rng(14)
    sel = np.union1d(np.argsort(pair_len, kind="stable")[-K1_LONGEST:],
                     rng.choice(P_, K1_SAMPLE, replace=False))
    e = X.extension_streams(rd, X._pair_block(pairs, sel, "cuda"),
                            cfg.kmer_size)
    kinds = (e["T"].at & 3).unique().tolist()
    rc = pairs.seed_rc[sel]
    if sorted(kinds) != [0, 1, 2, 3] or not rc.any() or rc.all():
        raise AssertionError(f"K1's sample misses a strand: kinds {kinds}")
    Ls = -(-int(pair_len[sel].max()) // 16) * 16
    kern_s = P.run_streams(e["T"], e["Q"], cfg.xdrop, W1, P.NO_CAP, False,
                           longest=Ls, with_steps=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    plain_s = P.xdrop_plain(P.stream_rows(e["T"], Ls), e["T"].len,
                            P.stream_rows(e["Q"], Ls), e["Q"].len, cfg.xdrop,
                            W1, P.NO_CAP, False, with_steps=True)
    torch.cuda.synchronize()
    sample = dict(
        pairs=len(sel), extensions=int(kern_s.shape[1]), L=Ls,
        max_steps=int(kern_s[3].max()),
        plain_ms=1e3 * (time.perf_counter() - t0),
        err=int((kern_s.to(torch.int64) - plain_s.to(torch.int64)
                 ).abs().max()))
    print(f"bench first pass: K1 on {len(sel)} pairs (the {K1_LONGEST} "
          f"longest, both strands): " + json.dumps(sample), flush=True)
    del e, kern_s, plain_s
    # the plain version (~0.8 ms per antidiagonal, ~2 min over the whole
    # pass) runs on the first former batch only: its extensions, 8,192 of
    # the shortest pairs, stand for the pass in plain_ms and in max_abs_err
    sub = _batches(state, np.arange(P_))[:1]
    T, tl, Q, ql, _ = sub[0]
    out_k = P.extend_batch_packed(T, tl, Q, ql, cfg.xdrop,
                                  band=cfg.pallas_band, with_steps=True)
    sub_ms = cuda_ms(lambda: P.extend_batch_packed(T, tl, Q, ql, cfg.xdrop,
                                                   band=cfg.pallas_band))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p = P.extend_batch_packed_plain(T, tl, Q, ql, cfg.xdrop,
                                        band=cfg.pallas_band, with_steps=True)
    torch.cuda.synchronize()
    plain1 = 1e3 * (time.perf_counter() - t0)
    err1 = max(same(out_k, out_p), sample["err"])
    n1 = int(out1.shape[1])
    bound1, by1 = _bound_of(stream_bytes(reads, n1),
                            OPS_PER_CELL * W1 * int(out1[3].sum()))
    lv = state["levels"]
    rows.append(dict(
        name="xdrop_static (K1)", route="cuda",
        source="bella_tpu_torch/align/csrc/xdrop.cu",
        replaces="bella_tpu/align/pallas_xdrop.py:98",
        launches=state["k1_launches"],
        max_abs_err=max(err1, state["k1_err"], state["long"]["K1"]["err"],
                        lv["bench"]["err"], lv["demo"]["err"]),
        ms=ms1, plain_ms=plain1, bound_ms=bound1, bound_by=by1,
        library_ms=None,
        shapes=f"bench first pass: {n1} extensions in one launch, W={W1}",
        plain_shapes=f"first former batch: {T.shape[0]} extensions, kernel "
                     f"{sub_ms:.3f} ms",
        levels={k: lv[k] for k in ("bench", "demo")}, sample=sample,
    ))
    del ext, out1
    # K2: the adaptive tail of the capped-cascade bench run
    b2 = _batches(state, state["tail_pairs"])

    def k2():
        return [P.run_xdrop(T, tl, Q, ql, cfg.xdrop, cfg.band_width, 2 * L,
                            True, with_steps=True)
                for T, tl, Q, ql, L in b2]

    ms2 = cuda_ms(k2)
    out_k2 = k2()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out_p2 = [P.xdrop_plain(T, tl, Q, ql, cfg.xdrop, cfg.band_width, 2 * L,
                            True, with_steps=True)
              for T, tl, Q, ql, L in b2]
    torch.cuda.synchronize()
    plain2 = 1e3 * (time.perf_counter() - t0)
    err2 = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(out_k2, out_p2))
    bound2, by2 = _bound_ms(b2, [o[3] for o in out_k2], cfg.band_width)
    # K2's row: dataset D on the adaptive-band backend, where it runs on
    # every pair (the plain version on a sample of D's pairs); the bench
    # tail beside it
    ad = state["adaptive"]
    rows.append(dict(
        name="xdrop_adaptive (K2)", route="cuda",
        source="bella_tpu_torch/align/csrc/xdrop.cu",
        replaces="bella_tpu/align/xdrop.py:58",
        launches=ad["launches"],
        max_abs_err=max(err2, ad["sample_err"], state["k2_err"],
                        state["long"]["K2"]["err"]),
        ms=ad["ms"], plain_ms=ad["sample_plain_ms"], bound_ms=ad["bound_ms"],
        bound_by=ad["bound_by"], library_ms=None,
        shapes=f"dataset D, aligner_backend=jax: {ad['extensions']} "
               f"extensions in {ad['rerun_launches']} launches, W={ad['W']}; "
               f"in-path {ad['in_path_ms']:.1f} ms",
        plain_shapes=f"sample of {ADAPTIVE_SAMPLE} pairs: "
                     f"{ad['sample_extensions']} extensions, kernel "
                     f"{ad['sample_ms']:.3f} ms",
        bench_tail=dict(ms=ms2, plain_ms=plain2, bound_ms=bound2,
                        bound_by=by2, launches=state["k2_launches"],
                        extensions=sum(T.shape[0] for T, *_ in b2)),
    ))
    # K3: off the main path; the extension prep of dataset D's first pass
    # in the batches the path took before its levels became single
    # launches; the plain version is the eager code of before K3
    calls = state["demo_prep_calls"]

    def k3():
        for c in calls:
            X.launch_prep(*c)

    def k3_plain():
        for c in calls:
            X.prepare_batch_plain(*c)

    ms3 = cuda_ms(k3)
    plain3 = cuda_ms(k3_plain, reps=1, warmups=0)
    bound3, by3 = prep_bound(calls)
    widths = [c[3] for c in calls]
    rows.append(dict(
        name="ext_prep (K3)", route="cuda",
        source="bella_tpu_torch/align/csrc/xdrop.cu",
        replaces="bella_tpu/align/xdrop.py:416",
        launches=None,  # the main-path runs' sum, below
        max_abs_err=max([state["k3_err"]] + [
            v["err"] for v in state["levels"].values()]),
        ms=ms3, plain_ms=plain3, bound_ms=bound3, bound_by=by3,
        library_ms=None,
        shapes=f"dataset D's first pass in its former batches: "
               f"{len(calls)} launches, "
               f"{sum(c[1].shape[1] for c in calls)} pairs, L "
               f"{min(widths)}-{max(widths)}; on the main path none",
    ))
    # each kernel's launches on every main-path run, and the x-drop
    # kernels' long-key instantiation at the long phase's shape (plain
    # version on the CPU)
    for r, key, lk in ((rows[0], "xdrop_static", "K1"),
                       (rows[1], "xdrop_adaptive", "K2"),
                       (rows[2], "ext_prep", None)):
        r["launches_by_run"] = {label: run["launches"][key]
                                for label, run in state["runs"].items()}
        r["launches_by_shard"] = {
            f"{label} ({run['shards']})": {
                k.split(" ", 1)[1]: v for k, v in
                run["kernel_by_shard"].items() if k.startswith(key + " ")}
            for label, run in state["runs"].items() if "shards" in run}
        if lk:
            r["long_key"] = {k: state["long"][lk][k] for k in (
                "ms", "plain_ms", "bound_ms", "bound_by", "err", "W",
                "lengths")}
    rows[2]["launches"] = sum(rows[2]["launches_by_run"].values())
    for r in rows:
        what = "the extension prep" if r is rows[2] else "x-drop"
        print(f"kernel {r['name']}: {r['ms']:.3f} ms on the card, plain "
              f"{r['plain_ms']:.1f} ms, bound {r['bound_ms']:.4f} ms "
              f"({r['bound_by']}), {r['launches']} launches on the main "
              f"path; no single PyTorch call computes {what} ({r['shapes']}"
              + (f"; plain on the {r['plain_shapes']}"
                 if "plain_shapes" in r else "") + ")")
    if err1 or err2:
        raise AssertionError("a kernel disagrees with its plain version at "
                             "the main path's shapes")
    return rows


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not (os.path.isdir(os.path.join(here, "bella_tpu_torch"))
            and os.path.isfile(os.path.join(here, "bench_torch.py"))):
        print("chip_smoke: bella_tpu_torch and bench_torch.py are not "
              "beside this script", file=sys.stderr)
        return 2
    sys.path.insert(0, here)
    from bella_tpu_torch.align import _build
    from bella_tpu_torch.utils.measure import nvidia_smi

    smi = nvidia_smi()
    print(f"card: {smi}")
    print("toolchain: " + json.dumps(toolchain()))
    t0 = time.perf_counter()
    _build.xdrop_lib()
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    for line in ptxas_summary():
        print(f"ptxas {line}")

    import tempfile

    state: dict = {}
    failed = []
    table = []
    with tempfile.TemporaryDirectory() as work:
        state["work"] = work
        state["long_plain"] = start_long_plain(work)
        try:
            for name, fn in (
                    ("kernels", phase_kernels), ("long", phase_long),
                    ("small", phase_small), ("bench", phase_bench),
                    ("demo", phase_demo), ("adaptive", phase_adaptive),
                    ("ladder", phase_ladder),
                    ("wide", phase_wide), ("ultralong", phase_ultralong),
                    ("modes", phase_modes), ("hifi", phase_hifi),
                    ("multidev", phase_multidev),
                    ("multiproc", phase_multiproc),
                    ("spgemm", phase_spgemm), ("native", phase_native),
                    ("tools", phase_tools), ("table", phase_table)):
                t = time.perf_counter()
                try:
                    out = fn(state)
                    if name == "table":
                        table = out
                except Exception:
                    traceback.print_exc()
                    failed.append(name)
                print(f"phase {name}: {'FAILED' if name in failed else 'ok'} "
                      f"in {time.perf_counter() - t:.1f} s", flush=True)
                if name in ("kernels", "bench") and failed:
                    break  # later phases need the kernels and the bench run
        finally:
            for _, proc in state["long_plain"].values():
                if proc.poll() is None:
                    proc.kill()
                proc.communicate()
    if failed:
        print(f"chip_smoke: failed phases {failed}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": table}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--dist-worker"]:
        sys.exit(dist_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4],
                             sys.argv[5]))
    sys.exit(main())
