"""The x-drop kernels fed by stream descriptors, on the card.

K1 and K2 read each extension's bases straight from the reads' words
through its descriptor (extension_streams, run_streams). Here they are
held, bit for bit and steps included, to the extension prep K3 followed
by K1 and K2 on its materialised rows, on the same pairs: W 128, 256 and
1,024 in both modes, a level that needs the long key (a read of 140,000
bases beside short ones), and a single pair. The pairs overlap on a
common genome (3 % substitutions) with true seeds on both strands, so
their extensions run deep into both streams, beside random pairs that
drop at once. K1's grouped tile (several extensions a warp at W <= 256)
is held to the plain version directly, at the bands and batch sizes
where its groups could go wrong.

The reads' ragged words, packed on the card from their codes
(_upload_reads' card branch, pack_ragged_kernel), are held bit for bit to
the host's pack_words_ragged: ragged lengths around a word, a read of
131,085 bases, and the first 512 reads of dataset D, on whose first pass
K1 gives the same rows from either.

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


def _grouped_batch(seed: int, B: int, n: int = 2400):
    """B extensions on one flat word stream that holds a random genome G
    and the reverse complement of a copy of G with 3 % substitutions, in
    six kinds by e % 6 (lengths up to n): G against the copy read
    backwards and complemented, which matches and runs deep; the same the
    other way round; G against itself, forwards (equal lengths, so it runs
    to t_len + q_len) and complemented; G against an unrelated stretch,
    which drops within a few antidiagonals; and lengths 0 and 1. So the
    groups of one warp end on different steps, and every kind of
    descriptor is read."""
    rng = np.random.default_rng(seed)
    N = 4 * n
    g = rng.integers(0, 4, N)
    m = g.copy()
    r = rng.random(N) < 0.03
    m[r] = (m[r] + 1) % 4
    flat = np.concatenate([g, (3 - m)[::-1]])
    words = P.pack_words(torch.from_numpy(flat[None, :])).reshape(-1)
    ta, qa, tl, ql = [], [], [], []
    for e in range(B):
        kind = e % 6
        s = int(rng.integers(0, N - n))
        a, b = (int(x) for x in rng.integers(1, n, 2))
        fwd, rc = 4 * s, 4 * (2 * N - 1 - s) + 3  # G[s..]; the copy's m[s..]
        if kind == 0:
            t, q = fwd, rc
        elif kind == 1:
            t, q = rc, fwd
        elif kind == 2:
            t, q, b = fwd, fwd, a
        elif kind == 3:
            t, q, b = fwd + 1, fwd + 1, a
        elif kind == 4:
            t, q = fwd, 4 * int(rng.integers(0, N - n))
        else:
            t, q = fwd, rc
            a, b = (0, 0) if e % 12 == 5 else (1, int(rng.integers(0, 2)))
        ta.append(t)
        qa.append(q)
        tl.append(a)
        ql.append(b)

    def streams(at, lens):
        return P.Streams(words.cuda(), torch.tensor(at, dtype=torch.int64,
                                                    device="cuda"),
                         torch.tensor(lens, dtype=torch.int32, device="cuda"))

    return streams(ta, tl), streams(qa, ql), n


def _grouped_against_plain(B, W, xdrop=XDROP, cap=P.NO_CAP, seed=21):
    """The kernel's launch (the grouped tile) and the plain version on the
    same streams, with steps; the launch's grouped count; t_len + q_len."""
    from bella_tpu_torch.utils import log as ulog

    ts, qs, n = _grouped_batch(seed, B)
    ulog.reset()
    got = P.run_streams(ts, qs, xdrop, W, cap, False, longest=n,
                        with_steps=True)
    grouped = ulog.COUNTS.get("xdrop.grouped_extensions")
    L = -(-n // 16) * 16
    want = P.xdrop_plain(P.stream_rows(ts, L), ts.len, P.stream_rows(qs, L),
                         qs.len, xdrop, W, cap, False, with_steps=True)
    torch.cuda.synchronize()
    return got, want, grouped, ts.len + qs.len


@pytest.mark.card
@pytest.mark.parametrize("B", [1, 13, 1027])
@pytest.mark.parametrize("W", [64, 100, 128, 200, 256])
def test_grouped_tile_matches_plain(card, W, B):
    assert P.grouped_tile(W, False, False) > 0
    got, want, grouped, total = _grouped_against_plain(B, W)
    assert torch.equal(got, want)
    assert grouped == B
    if B > 13:
        steps, ends = got[3], total - 1  # d runs 2 .. t_len + q_len
        assert int((steps <= 1).sum()) > 0  # some end at once
        assert bool(((steps == ends) & (ends > 2000)).any())  # some run out


@pytest.mark.card
@pytest.mark.parametrize("W", [128, 256])
def test_grouped_tile_matches_plain_with_a_binding_cap(card, W):
    cap = P.static_step_cap(500)
    got, want, _, _ = _grouped_against_plain(257, W, cap=cap, seed=22)
    assert torch.equal(got, want)
    assert int(got[3].max()) == cap


@pytest.mark.card
def test_grouped_tile_matches_plain_at_xdrop_zero(card):
    # at xdrop 0 a pair whose first bases differ dies on its first
    # antidiagonal, and one whose first bases match on its second (an odd
    # antidiagonal's max lies below the best): groups of a warp end on
    # either half of a turn
    got, want, _, _ = _grouped_against_plain(515, 128, xdrop=0, seed=23)
    assert torch.equal(got, want)
    assert int((got[3] == 1).sum()) > 10 and int((got[3] == 2).sum()) > 10


@pytest.mark.card
def test_resident_extensions_count_groups(card):
    """At W <= 256 the static launch's slots are its thread groups: the
    same blocks an SM at every group size, 256 / group threads a block."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_sm = set()
    for W in (64, 100, 128, 200, 256):
        gs = P.grouped_tile(W, False, False)
        n = P.resident_extensions(W, False)
        assert n % (sms * (256 // gs)) == 0, (W, gs, n)
        per_sm.add(n // (sms * (256 // gs)))
    assert len(per_sm) == 1 and per_sm.pop() >= 1
    # the one-warp tiles: a warp an extension
    assert P.grouped_tile(512, False, False) == 0
    assert P.resident_extensions(512, False) % (sms * 8) == 0


def _pack_corpus(name: str):
    """The reads of one pack case: lengths around a word's 16 bases (with
    reads of no base among them), a read of 131,085 bases beside short
    ones, or the first 512 reads of dataset D."""
    rng = np.random.default_rng(31)
    if name == "D512":
        from bench_torch import demo_corpus

        _, d, _ = demo_corpus()
        n = 512
        return ReadSet(d.names[:n], d.codes[:d.offsets[n]].copy(),
                       d.offsets[:n + 1].copy())
    lens = ([1, 15, 16, 17, 0, 31, 32, 33, 0, 2, 1] if name == "ragged"
            else [7, 131_085, 33, 5000])
    lens = np.array(lens, np.int64)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(0, 4, int(offsets[-1])).astype(np.uint8)
    return ReadSet([f"r{i}" for i in range(len(lens))], codes, offsets)


@pytest.mark.card
@pytest.mark.parametrize("name", ["ragged", "long", "D512"])
def test_card_pack_matches_host_pack(card, name):
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.overlap.pairs import detect_overlaps
    from bella_tpu_torch.utils import log as ulog

    reads = _pack_corpus(name)
    ulog.reset()
    rd = X._upload_reads(reads, "cuda")
    assert ulog.COUNTS["align.packed_reads"] == reads.num_reads
    assert ulog.COUNTS["launch.pack_ragged"] == 1
    flat, off_w = X.pack_words_ragged(reads)
    host = X._Reads(torch.from_numpy(flat.view(np.int32).copy()).to(card),
                    torch.from_numpy(off_w.astype(np.int64)).to(card),
                    torch.from_numpy(reads.lengths.astype(np.int64)).to(card))
    for f in ("words", "off_w", "lens"):
        got, want = getattr(rd, f), getattr(host, f)
        assert got.dtype == want.dtype and torch.equal(got, want), f
    if name != "D512":
        return
    # K1's rows of the first pass, from either set of words
    cfg = BellaConfig()
    pairs = detect_overlaps(reads, cfg, "cuda")[0]
    assert pairs.num_pairs > 100
    lens = reads.lengths
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    sel = np.arange(pairs.num_pairs)

    def first_pass(r):
        return X._extend_pairs(r, pairs, sel, pair_len, cfg.xdrop,
                               cfg.kmer_size, cfg.pallas_band, 0, False,
                               cfg.align_batch)

    got, want = first_pass(rd), first_pass(host)
    assert np.array_equal(got, want) and int(got[0].max()) > 1000
