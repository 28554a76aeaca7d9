"""The adaptive-band aligner backend (aligner_backend="jax") against
bella_tpu's, on the CPU.

bella_tpu's adaptive backend extends every candidate pair with its
lax.while_loop extend_batch at band_width (plain XLA here, no interpret
mode); the port's runs the plain version of kernel K2 on every pair. Both
skip the rescue cascade, the exactness tail and the K1-against-K2 check.
Every comparison is exact: integer arrays equal, rows byte for byte.

The corpus drifts: its reads carry long deletions (20-60 bp) beside 4 %
noise, so the static-band path (K1 with the cascade) and the adaptive
path end some extensions at different cells, and the test first asserts
that their rows differ.
"""

import dataclasses

import numpy as np
import pytest

from bella_tpu import BellaConfig as RefConfig
from bella_tpu.align.xdrop import align_candidates as ref_align
from bella_tpu.align.xdrop import pad_reads as ref_pad_reads
from bella_tpu.io import ReadSet as RefReadSet
from bella_tpu.pipeline import run_pipeline as ref_run
from bella_tpu_torch.align import pallas_xdrop as P
from bella_tpu_torch.align import xdrop as X
from bella_tpu_torch.config import (
    DROPPED_FIELDS, BellaConfig, config_from_reference,
)
from bella_tpu_torch.io.fastq import ReadSet
from bella_tpu_torch.io.simulate import write_fastq
from bella_tpu_torch.pipeline import run_files, run_pipeline
import torch_test_support  # noqa: F401 (one torch thread)

ALN = ("score", "beg_h", "end_h", "beg_v", "end_v", "strand_rc")
PAIRS = ("read_h", "read_v", "pos_h", "pos_v", "count", "matches",
         "overlap_est", "seed_rc")
# the reference cases: the default band, the reference's band (31), a
# binding step cap, and the modular branch (two k-mer passes)
CASES = {
    "default": dict(),
    "band31": dict(band_width=31),
    "max_steps": dict(max_steps=300),
    "split2": dict(split_count=2),
}


def drift_corpus() -> ReadSet:
    """16 reads of 700-1,300 bp from a 5 kbp genome: 2 % substitutions,
    2 % deletions, three 20-60 bp deletions a read; every third read
    reverse-complemented."""
    rng = np.random.default_rng(69)
    g = rng.integers(0, 4, 5000).astype(np.uint8)
    seqs = []
    for i in range(16):
        n = int(rng.integers(700, 1300))
        s = int(rng.integers(0, len(g) - n))
        f = g[s:s + n].copy()
        r = rng.random(n)
        f[r < 0.02] = (f[r < 0.02] + 1) % 4
        f = f[~((r >= 0.02) & (r < 0.04))]
        for _ in range(3):
            a = int(rng.integers(0, len(f) - 100))
            f = np.concatenate([f[:a], f[a + int(rng.integers(20, 60)):]])
        seqs.append((3 - f)[::-1] if i % 3 == 0 else f)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum([len(x) for x in seqs], out=offsets[1:])
    return ReadSet([f"r{i}" for i in range(len(seqs))],
                   np.concatenate(seqs), offsets)


def _ref_reads(reads) -> RefReadSet:
    return RefReadSet(list(reads.names), reads.codes, reads.offsets)


def _port_config(**kw) -> BellaConfig:
    ref = RefConfig(aligner_backend="jax", **kw)
    return config_from_reference(dataclasses.asdict(ref))


@pytest.fixture(scope="module")
def reads():
    return drift_corpus()


@pytest.fixture(scope="module")
def ref_runs(reads):
    """bella_tpu's run_pipeline with the adaptive backend, each case."""
    rr = _ref_reads(reads)
    return {name: ref_run(rr, RefConfig(aligner_backend="jax", **kw))
            for name, kw in CASES.items()}


@pytest.fixture(scope="module")
def adaptive_default(reads):
    return run_pipeline(reads, _port_config(), device="cpu")


def _assert_same_run(ref, got):
    assert ref.rows and got.rows == ref.rows
    assert (got.num_kmers, got.nnz) == (ref.num_kmers, ref.nnz)
    order = np.lexsort((ref.pairs.read_v, ref.pairs.read_h))
    for f in PAIRS:
        np.testing.assert_array_equal(getattr(got.pairs, f),
                                      getattr(ref.pairs, f)[order], f)
    for f in ALN:
        np.testing.assert_array_equal(getattr(got.alignment, f),
                                      getattr(ref.alignment, f)[order], f)


def test_static_path_rows_differ(reads, adaptive_default):
    """The corpus tells the two paths apart: the static-band path's rows
    (auto, pallas) are not the adaptive path's; the adaptive path reports
    no cascade and no tail."""
    static = run_pipeline(reads, BellaConfig(), device="cpu")
    aln = adaptive_default.alignment
    assert static.alignment.rescue_levels  # the corpus saturates K1's band
    assert static.rows != adaptive_default.rows
    assert aln.rescue_levels == () and aln.tail_pairs.size == 0


@pytest.mark.parametrize("case", list(CASES))
def test_pipeline_matches_reference(reads, ref_runs, adaptive_default, case):
    """run_pipeline with aligner_backend="jax": pairs, alignment arrays and
    M4 rows equal bella_tpu's, on the fused branch (default, band 31, a
    step cap) and on the modular one (split_count 2)."""
    got = (adaptive_default if case == "default" else
           run_pipeline(reads, _port_config(**CASES[case]), device="cpu"))
    _assert_same_run(ref_runs[case], got)


def test_align_candidates_padded_matches_reference(reads, ref_runs):
    """align_candidates from pad_reads' matrix (its first argument), on the
    reference's pairs at band 31: bella_tpu's arrays, exactly."""
    ref = ref_runs["band31"]
    mat, lens = X.pad_reads(reads)
    np.testing.assert_array_equal(mat, ref_pad_reads(_ref_reads(reads))[0])
    cfg = _port_config(band_width=31)
    got = X.align_candidates(mat, lens, ref.pairs, cfg, device="cpu")
    want = ref_align(None, lens, ref.pairs,
                     RefConfig(aligner_backend="jax", band_width=31),
                     reads=_ref_reads(reads))
    for f in ALN:
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f), f)
        np.testing.assert_array_equal(getattr(got, f),
                                      getattr(ref.alignment, f), f)


def test_every_pair_goes_through_k2(reads, ref_runs, monkeypatch):
    """Every extension of the adaptive path goes through K2's entry
    (run_streams in adaptive mode at band_width), one call a batch of the
    plain version, with the step cap exactly max_steps when it is set and
    otherwise one that no extension reaches (at least its t_len + q_len);
    K1 is never called."""
    calls = []
    run = X.run_streams

    def spy(ts, qs, xdrop, W, cap, adaptive, *a, **kw):
        calls.append((len(ts.len), W, cap, adaptive,
                      int((ts.len + qs.len).max())))
        return run(ts, qs, xdrop, W, cap, adaptive, *a, **kw)

    def no_k1(*a, **k):
        raise AssertionError("the adaptive path called K1")

    monkeypatch.setattr(X, "run_streams", spy)
    monkeypatch.setattr(X, "run_xdrop", no_k1)
    pairs = ref_runs["default"].pairs
    lens = reads.lengths.astype(np.int32)
    for kw, cap in ((dict(band_width=31, max_steps=300), 300),
                    (dict(), P.NO_CAP)):
        calls.clear()
        X.align_candidates(None, lens, pairs, _port_config(**kw),
                           batch_size=16, reads=reads, device="cpu")
        W = kw.get("band_width", 128)
        assert sum(c[0] for c in calls) == 2 * pairs.num_pairs
        assert len(calls) == -(-pairs.num_pairs // 16)
        assert all(c[1:4] == (W, cap, True) for c in calls), calls
        assert kw or all(c[2] >= c[4] for c in calls)


def test_selfcheck_runs_no_kernel_check(reads, adaptive_default,
                                        monkeypatch):
    """--selfcheck under the adaptive backend runs the host oracles but
    not the K1-against-K2 check (bella_tpu runs it only with its Pallas
    backend); the rows are the plain adaptive run's."""
    def no_check(*a, **k):
        raise AssertionError("the K1-against-K2 check ran")

    monkeypatch.setattr(X, "_align_check", no_check)
    got = run_pipeline(reads, _port_config(selfcheck=True), device="cpu")
    assert got.rows == adaptive_default.rows


def test_two_cpu_shards_match_one_device(reads, ref_runs):
    """BellaConfig(devices=2) on two CPU shards: each share runs the
    adaptive path, and the rows and arrays are the reference's."""
    got = run_pipeline(reads, _port_config(devices=2), device="cpu")
    _assert_same_run(ref_runs["default"], got)


def test_run_files_carries_the_backend(reads, adaptive_default, tmp_path):
    """run_files passes the field on: the rows written are the adaptive
    path's, not the static path's."""
    fq = tmp_path / "reads.fastq"
    write_fastq(str(fq), reads)
    out = tmp_path / "out.m4"
    run_files(str(fq), _port_config(), str(out), device="cpu", native=False)
    assert out.read_text() == "".join(adaptive_default.rows)


@pytest.mark.parametrize("backend,adaptive", [
    ("auto", False), ("pallas", False), ("jax", True), ("anything", True)])
def test_backend_rule(backend, adaptive):
    """"auto" and "pallas" take the static-band path, any other value the
    adaptive one (bella_tpu's use_pallas = backend == "pallas", with "auto"
    on the card's kernels); config_from_reference carries the field, and
    only prewarm is dropped."""
    assert BellaConfig(aligner_backend=backend).adaptive_aligner is adaptive
    ref = RefConfig(aligner_backend=backend, prewarm=False)
    got = config_from_reference(dataclasses.asdict(ref))
    assert got.aligner_backend == backend
    assert DROPPED_FIELDS == ("prewarm",)
