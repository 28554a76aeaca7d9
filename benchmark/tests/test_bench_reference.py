"""The plain reference against the port on tiny corpora on the CPU:
detection field for field (both seed rules), alignment (static band with
its cascade, adaptive band), decision and M4 rows byte for byte; and one
x-drop extension against the port's plain kernel on random sequences."""

import dataclasses

import numpy as np
import pytest
import torch

from benchmark.gen.simulate import random_genome, sample_reads
from benchmark.reference import decide as D
from benchmark.reference import detect as R
from benchmark.reference import xdrop as X

torch.set_num_threads(1)


def port_run(corpus, backend):
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.fastq import ReadSet
    from bella_tpu_torch.pipeline import run_pipeline
    from bella_tpu_torch.utils import log

    was = log._ENABLED
    log.set_enabled(False)
    try:
        cfg = BellaConfig(aligner_backend=backend)
        res = run_pipeline(ReadSet(corpus.names, corpus.codes,
                                   corpus.offsets), cfg, device="cpu")
    finally:
        log.set_enabled(was)
    return res, dataclasses.asdict(cfg)


@pytest.mark.parametrize("genome,reads,mean,low,seed", [
    (12000, 24, 1500, 500, 3),     # the packed seed rule
    (150000, 6, 30000, 20000, 5),  # reads over 65,535 bp: the unpacked rule
])
def test_detection_matches_the_port(genome, reads, mean, low, seed):
    c = sample_reads(random_genome(genome, seed=seed), reads, mean, low,
                     0.15, seed=seed + 1, circular=False)
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.io.fastq import ReadSet
    from bella_tpu_torch.overlap.pairs import detect_overlaps

    got, _, _ = detect_overlaps(ReadSet(c.names, c.codes, c.offsets),
                                BellaConfig(), device="cpu")
    cfg = dataclasses.asdict(BellaConfig())
    table = np.stack([getattr(got, f).astype(np.int64) for f in R.FIELDS], 1)
    want = R.detect_sample(c.codes, c.offsets, np.ones(c.num_reads, bool),
                           cfg, "cpu")
    assert len(want) > 5
    assert np.array_equal(table, want.table())
    part = np.zeros(c.num_reads, bool)
    part[::3] = True
    sub = R.detect_sample(c.codes, c.offsets, part, cfg, "cpu")
    mine = part[table[:, 0]] | part[table[:, 1]]
    assert np.array_equal(table[mine], sub.table())
    # 32-bit k-mer words (the control) change the pairs
    ctl = R.detect_sample(c.codes, c.offsets, np.ones(c.num_reads, bool),
                          cfg, "cpu", key_bits=32)
    assert not np.array_equal(ctl.table(), want.table())


@pytest.mark.parametrize("backend", ["auto", "jax"])
def test_alignment_decision_and_rows_match_the_port(backend):
    c = sample_reads(random_genome(20000, seed=11), 24, 2500, 800, 0.15,
                     seed=12, circular=False)
    res, cfg = port_run(c, backend)
    ref = R.detect_sample(c.codes, c.offsets, np.ones(c.num_reads, bool),
                          cfg, "cpu")
    al = X.align_pairs(c.codes, c.offsets, ref, cfg, workers=1)
    ended = al[:, 5]
    al = al[:, :5]
    a = res.alignment
    got = np.stack([a.score, a.beg_h, a.end_h, a.beg_v, a.end_v], 1)
    assert np.array_equal(got, al)
    # the route each pair's alignment ended at: the adaptive band on the
    # adaptive backend; on the static one, a band past the first wherever
    # the alignment drifted past the first band's edge
    if backend == "jax":
        assert set(ended.tolist()) == {X.ADAPTIVE}
    else:
        from benchmark import check

        assert set(ended.tolist()) <= set(check.bands(cfg)) | {X.ADAPTIVE}
        lv = check.levels(cfg, check.drift(c.lengths, ref, al,
                                           cfg["kmer_size"]))
        assert not np.any((lv > 0) & (ended == check.bands(cfg)[0]))
    lens = c.lengths
    passed, ov = D.decide(*al.T, lens[ref.read_h], lens[ref.read_v],
                          cfg["error_rate"], cfg["delta_chernoff"])
    idx = np.flatnonzero(passed)
    assert len(idx)
    lines = D.m4_lines(c.names, lens, ref.read_h[idx], ref.read_v[idx],
                       ref.count[idx], al[idx, 0], ov[idx],
                       ref.seed_rc[idx], al[idx, 3], al[idx, 4],
                       al[idx, 1], al[idx, 2])
    assert [x.decode() for x in lines] == res.rows


def test_extension_matches_the_ports_plain_kernel():
    from bella_tpu_torch.align.pallas_xdrop import pack_words, xdrop_plain

    rng = np.random.default_rng(0)
    B, L = 8, 600
    T = rng.integers(0, 4, (B, L)).astype(np.uint8)
    Q = T.copy()
    noise = rng.random((B, L)) < np.linspace(0.02, 0.4, B)[:, None]
    Q[noise] = rng.integers(0, 4, int(noise.sum()))
    Q[::2] = np.roll(Q[::2], 3, axis=1)  # indel-like drift off the diagonal
    tl = rng.integers(0, L + 1, B)
    ql = rng.integers(0, L + 1, B)
    for W, adaptive in [(128, False), (256, False), (128, True), (31, True)]:
        out = xdrop_plain(
            pack_words(torch.from_numpy(T)), torch.from_numpy(tl).int(),
            pack_words(torch.from_numpy(Q)), torch.from_numpy(ql).int(), 7,
            W, 4 * L, adaptive).numpy()
        for b in range(B):
            assert X.extend(T[b, :tl[b]], Q[b, :ql[b]], 7, W,
                            adaptive) == tuple(out[:, b])
