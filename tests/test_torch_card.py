"""The x-drop kernels fed by stream descriptors, on the card.

K1 and K2 read each extension's bases straight from the reads' words
through its descriptor (extension_streams, run_streams). Here they are
held, bit for bit and steps included, to the extension prep K3 followed
by K1 and K2 on its materialised rows, on the same pairs: W 128, 256 and
1,024 in both modes, a level that needs the long key (a read of 140,000
bases beside short ones), and a single pair. The pairs overlap on a
common genome (3 % substitutions) with true seeds on both strands, so
their extensions run deep into both streams, beside random pairs that
drop at once.

Every test takes the `card` fixture and skips without a CUDA card. The
file imports no JAX; run it on the card with

    python -m pytest -o addopts= --noconftest -p no:cacheprovider \\
        tests/test_torch_card.py -m card
"""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

import torch_test_support  # noqa: F401 (one torch thread)
from bella_tpu_torch.align import pallas_xdrop as P
from bella_tpu_torch.align import xdrop as X
from bella_tpu_torch.io.fastq import ReadSet

K, XDROP = 17, 7


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _corpus(seed: int, n_reads: int, long_read: int = 0):
    """Reads cut from one genome with 3 % substitutions, every third one
    reverse-complemented (and a long read of `long_read` bases first, when
    given); pairs of overlapping reads seeded at a shared genome position
    on the right strand, and random pairs on both strands."""
    rng = np.random.default_rng(seed)
    g = rng.integers(0, 4, max(60_000, long_read + 1000)).astype(np.uint8)
    spans, seqs, rcs = [], [], []
    if long_read:
        spans.append((0, long_read))
    while len(spans) < n_reads:
        n = int(rng.integers(200, 6000))
        s = int(rng.integers(0, min(len(g), 60_000) - n))
        spans.append((s, s + n))
    for i, (s, e) in enumerate(spans):
        f = g[s:e].copy()
        r = rng.random(len(f)) < 0.03
        f[r] = (f[r] + 1) % 4
        rc = i % 3 == 2
        seqs.append((3 - f)[::-1] if rc else f)
        rcs.append(rc)
    lens = np.array([len(x) for x in seqs], np.int64)
    offsets = np.zeros(len(seqs) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    reads = ReadSet([f"r{i}" for i in range(len(seqs))],
                    np.concatenate(seqs), offsets)
    h, v, ph, pv, src = [], [], [], [], []
    for a in range(len(spans)):
        for b in range(len(spans)):
            (s1, e1), (s2, e2) = spans[a], spans[b]
            lo, hi = max(s1, s2), min(e1, e2) - K
            if a == b or rcs[b] or hi - lo < 50 or rng.random() > 0.3:
                continue
            p = int(rng.integers(lo, hi))
            # V forward; H's seed on its own strand, flipped back where it
            # was reverse-complemented
            h.append(a)
            v.append(b)
            ph.append(lens[a] - (p - s1) - K if rcs[a] else p - s1)
            pv.append(p - s2)
            src.append(rcs[a])
    m = len(h)
    rh, rv = rng.integers(0, len(spans), (2, m))
    ok = np.minimum(lens[rh], lens[rv]) > K
    rh, rv = rh[ok], rv[ok]
    pairs = SimpleNamespace(
        read_h=np.concatenate([h, rh]).astype(np.int64),
        read_v=np.concatenate([v, rv]).astype(np.int64),
        pos_h=np.concatenate([ph, (rng.random(len(rh))
                                   * (lens[rh] - K)).astype(np.int64)]),
        pos_v=np.concatenate([pv, (rng.random(len(rv))
                                   * (lens[rv] - K)).astype(np.int64)]),
        seed_rc=np.concatenate([src, rng.random(len(rh)) < 0.5]).astype(bool))
    return reads, pairs


def _both(reads, pairs, rows, band: int, adaptive: bool):
    """(descriptor-fed result, K3 + K1/K2 result), each (4, 2B) with
    steps, on the card."""
    rd = X._upload_reads(reads, "cuda")
    blk = X._pair_block(pairs, rows, "cuda")
    lens = reads.lengths
    L = -(-int(np.maximum(lens[pairs.read_h[rows]],
                          lens[pairs.read_v[rows]]).max()) // 16) * 16
    W = band if adaptive else P.round_band(band)
    ext = X.extension_streams(rd, blk, K)
    got = P.run_streams(ext["T"], ext["Q"], XDROP, W, P.NO_CAP, adaptive,
                        longest=L, with_steps=True)
    prep = X.launch_prep(rd, blk, K, L)
    cap = 2 * L if adaptive else P.static_step_cap(2 * L)
    want = P.run_xdrop(prep["T"], prep["t_len"], prep["Q"], prep["q_len"],
                       XDROP, W, cap, adaptive, with_steps=True)
    torch.cuda.synchronize()
    return got, want


@pytest.mark.card
@pytest.mark.parametrize("adaptive", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("band", [128, 256, 1024])
def test_streams_match_prep_then_kernel(card, band, adaptive):
    reads, pairs = _corpus(11, 60)
    rows = np.arange(len(pairs.read_h))
    got, want = _both(reads, pairs, rows, band, adaptive)
    assert torch.equal(got, want)
    assert int(got[3].max()) > 2000  # extensions ran deep


@pytest.mark.card
@pytest.mark.parametrize("adaptive", [False, True], ids=["K1", "K2"])
def test_streams_match_prep_then_kernel_long_key(card, adaptive):
    from bella_tpu_torch.utils import log as ulog

    reads, pairs = _corpus(12, 30, long_read=140_000)
    rows = np.arange(len(pairs.read_h))
    assert (pairs.read_h == 0).any() or (pairs.read_v == 0).any()
    ulog.reset()
    got, want = _both(reads, pairs, rows, 128, adaptive)
    assert torch.equal(got, want)
    name = "launch.xdrop_adaptive" if adaptive else "launch.xdrop_static"
    # the level split, on both sides (run_xdrop is run_streams on the K3
    # rows): a long-key launch of its own for the long extensions and an
    # int32-key launch for the rest
    assert ulog.COUNTS[name + "_long_key"] == 2
    assert ulog.COUNTS[name] == 4


@pytest.mark.card
@pytest.mark.parametrize("adaptive", [False, True], ids=["K1", "K2"])
def test_streams_match_prep_then_kernel_one_pair(card, adaptive):
    reads, pairs = _corpus(13, 20)
    got, want = _both(reads, pairs, np.array([0]), 128, adaptive)
    assert got.shape == (4, 2) and torch.equal(got, want)
