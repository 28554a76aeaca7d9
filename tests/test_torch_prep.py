"""The extension prep of the port (prepare_batch: kernel K3 on the card,
its plain version here) against bella_tpu's packed-word prep, on the CPU.

The plain version (extension_streams' descriptors gathered into rows)
equals bella_tpu's _prepare_extensions_packed on
_expand_words(pack_words_ragged(...)) base for base within every
stream's length (bella_tpu leaves later reads' bases beyond a length;
the port writes 'A'), at k = 17 and 31, with forward and reverse-
complement seeds, seeds at both ends of a read, read 0 and the last
read of the stream, and a read over 65,535 bp. The batch width comes
from the host and equals the width the card gave before. The slice as a
whole (prep, the adaptive-band extension and the combine) equals
bella_tpu's _seed_extend_batch. The x-drop fed by the descriptors (its
plain version: each stream gathered from the reads' words by its read,
start, direction and complement) equals bella_tpu's prep followed by the
x-drop's plain version on bella_tpu's rows, steps included, for all four
stream kinds, both strands, zero-length streams and the reads at both
ends of the word stream; word rows read back through their descriptors;
the CPU's reads are packed on the host (pack_words_ragged) and count no
reads packed on the card; on the card a level splits
into a long-key and an int32-key launch only where its extensions need
it. K3's launcher refuses CPU tensors, and a tensor on the card whose
kernel cannot be built raises rather than taking the plain version.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bella_tpu.align import xdrop as RX
from bella_tpu.io import ReadSet as RefReadSet
from bella_tpu_torch.align import _build
from bella_tpu_torch.align import pallas_xdrop as P
from bella_tpu_torch.align import xdrop as X
from bella_tpu_torch.io.fastq import ReadSet
from bella_tpu_torch.utils import log as ulog
import torch_test_support  # noqa: F401 (one torch thread)

STREAMS = (("lt", "T", 0), ("rt", "T", 1), ("lq", "Q", 0), ("rq", "Q", 1))
# (k, read lengths' upper end, lengths of extra long reads, seed)
CASES = {"k17": (17, 3000, (), 101), "k31": (31, 3000, (), 102),
         "k17 read of 70,001 bp": (17, 1500, (70_001,), 103)}


def _case(name):
    """Reads of lengths 1 .. top (no multiple of 16, a few beyond k only)
    plus the long ones, and seeded pairs: random forward and rc seeds,
    seeds at position 0 and at len - k of read 0 and of the last read."""
    k, top, longs, seed = CASES[name]
    rng = np.random.default_rng(seed)
    lens = rng.integers(1, top + 1, 40)
    lens = np.concatenate([[top - 3], lens, list(longs), [top - 7]])
    lens = np.where(lens % 16 == 0, lens + 1, lens).astype(np.int64)
    offsets = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(lens, out=offsets[1:])
    codes = rng.integers(0, 4, int(offsets[-1])).astype(np.uint8)
    reads = ReadSet([f"r{i}" for i in range(len(lens))], codes, offsets)
    ok = np.flatnonzero(lens >= k)
    last = len(lens) - 1
    h = list(rng.choice(ok, 48)) + [0, 0, last, last, 0, last]
    v = list(rng.choice(ok, 48)) + [last, last, 0, 0, 0, last]
    h, v = np.array(h), np.array(v)
    pos_h = (rng.random(len(h)) * (lens[h] - k + 1)).astype(np.int64)
    pos_v = (rng.random(len(v)) * (lens[v] - k + 1)).astype(np.int64)
    # the ends: position 0 and len - k, on both strands
    pos_h[-6:] = [0, lens[0] - k, 0, lens[last] - k, 0, 0]
    pos_v[-6:] = [lens[last] - k, 0, lens[0] - k, 0, 0, lens[last] - k]
    rc = rng.random(len(h)) < 0.5
    rc[-6:] = [False, True, True, False, True, False]
    if longs:  # every pair of the long read, on both strands
        big = len(lens) - 2
        h[:4], rc[:4] = big, [False, True, False, True]
        pos_h[:4] = [0, 0, lens[big] - k, lens[big] - k]
    pairs = SimpleNamespace(read_h=h, read_v=v, pos_h=pos_h, pos_v=pos_v,
                            seed_rc=rc)
    return k, reads, pairs


def _port(name):
    k, reads, pairs = _case(name)
    rows = np.arange(len(pairs.read_h))
    lens = reads.lengths
    L = -(-int(np.maximum(lens[pairs.read_h], lens[pairs.read_v]).max())
          // 16) * 16
    rd = X._upload_reads(reads, "cpu")
    return k, reads, pairs, X.prepare_batch(rd, X._pair_block(pairs, rows,
                                                              "cpu"), k, L)


def _bases(words) -> np.ndarray:
    """(n, Wp) words (any 32-bit type) -> (n, 16 Wp) base codes."""
    w = np.asarray(words).view(np.uint32).astype(np.uint64)
    return ((w[:, :, None] >> (2 * np.arange(16, dtype=np.uint64))) & 3
            ).reshape(len(w), -1).astype(np.uint8)


def _bella_tpu_prep(k, reads, pairs) -> dict:
    """bella_tpu's packed-word prep of every pair (its four streams, their
    lengths and the seed ends), as numpy arrays."""
    flat, off_w = RX.pack_words_ragged(
        RefReadSet(list(reads.names), reads.codes, reads.offsets))
    Wp = int(-(-reads.lengths.max() // 16))
    words = RX._expand_words(jnp.asarray(flat), jnp.asarray(off_w),
                             R=reads.num_reads, Wp=Wp)
    col = {f: jnp.asarray(getattr(pairs, f).astype(np.int32))
           for f in ("read_h", "read_v", "pos_h", "pos_v")}
    ref = RX._prepare_extensions_packed(
        words, jnp.asarray(reads.lengths.astype(np.int32)), col["read_h"],
        col["read_v"], col["pos_h"], col["pos_v"],
        jnp.asarray(pairs.seed_rc), k)
    return {key: np.asarray(v) for key, v in ref.items()}


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_prep_matches_bella_tpu(name):
    k, reads, pairs, got = _port(name)
    ref = _bella_tpu_prep(k, reads, pairs)
    B = len(pairs.read_h)
    for key in ("seed_end_h", "seed_end_v"):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(ref[key]))
    for stream, mat, half in STREAMS:
        n = np.asarray(ref[stream + "_len"])
        lens = got["t_len" if mat == "T" else "q_len"][half * B:(half + 1) * B]
        np.testing.assert_array_equal(lens.numpy(), n, err_msg=stream)
        want = _bases(np.asarray(ref[stream]))
        have = _bases(got[mat][half * B:(half + 1) * B].numpy())
        for b in range(B):
            assert n[b] >= 0
            np.testing.assert_array_equal(have[b, :n[b]], want[b, :n[b]],
                                          err_msg=f"{stream} pair {b}")
    assert got["T"].shape == got["Q"].shape == (2 * B, got["L"] // 16)


@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_prep_writes_A_beyond_lengths(name):
    _, _, _, got = _port(name)
    for mat, lens in (("T", "t_len"), ("Q", "q_len")):
        bases = _bases(got[mat].numpy())
        t = np.arange(bases.shape[1])[None, :]
        beyond = t >= got[lens].numpy()[:, None]
        assert beyond.any() and not bases[beyond].any()
        assert got[mat].dtype == torch.int32 and got[mat].is_contiguous()


def test_extension_batches_width_from_the_host():
    """Every batch's L is the width the card computed before (the
    longest read of the batch's pairs, rounded up to 16) and its streams
    are prepare_batch's on that batch."""
    k, reads, pairs = _case("k17")
    rd = X._upload_reads(reads, "cpu")
    lens = reads.lengths
    pair_len = np.maximum(lens[pairs.read_h], lens[pairs.read_v])
    sel = np.arange(len(pairs.read_h))
    n = 0
    for idx, ext in X.extension_batches(rd, pairs, sel, pair_len, k, 7):
        rows = sel[idx]
        bh = torch.from_numpy(pairs.read_h[rows].astype(np.int64))
        bv = torch.from_numpy(pairs.read_v[rows].astype(np.int64))
        old = int(torch.maximum(rd.lens[bh], rd.lens[bv]).max())
        assert ext["L"] == max(16, -(-old // 16) * 16)
        want = X.prepare_batch_plain(rd, X._pair_block(pairs, rows, "cpu"),
                                     k, ext["L"])
        for key in ("T", "Q", "t_len", "q_len", "seed_end_h", "seed_end_v"):
            assert torch.equal(ext[key], want[key]), key
        n += 1
    assert n == -(-len(sel) // 7)


# xdrop so large that no extension drops: every extension runs to its
# end or to the step cap, across dozens of words of both streams
NO_DROP = 100_000
DEEP = 1000


@pytest.mark.parametrize("adaptive", [False, True], ids=["K1", "K2"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_streams_xdrop_matches_prep_then_xdrop(name, adaptive):
    """The x-drop fed by the descriptors (run_streams on CPU tensors)
    against bella_tpu's prep followed by the x-drop's plain version on
    the rows bella_tpu wrote, steps included."""
    k, reads, pairs = _case(name)
    rd = X._upload_reads(reads, "cpu")
    blk = X._pair_block(pairs, np.arange(len(pairs.read_h)), "cpu")
    ext = X.extension_streams(rd, blk, k)
    ref = _bella_tpu_prep(k, reads, pairs)
    B = len(pairs.read_h)

    def rows(a, b):
        return torch.from_numpy(np.concatenate([ref[a], ref[b]]).view(
            np.int32))

    def lens(a, b):
        return torch.from_numpy(np.concatenate(
            [ref[a + "_len"], ref[b + "_len"]]).astype(np.int32))

    T, t_len, Q, q_len = rows("lt", "rt"), lens("lt", "rt"), \
        rows("lq", "rq"), lens("lq", "rq")
    for key, got, want in (
            ("t_len", ext["T"].len, t_len), ("q_len", ext["Q"].len, q_len),
            ("seed_end_h", ext["seed_end_h"], ref["seed_end_h"]),
            ("seed_end_v", ext["seed_end_v"], ref["seed_end_v"])):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=key)
    # both strands of H, all four kinds of descriptor, and empty left and
    # right streams on both sides
    assert pairs.seed_rc.any() and not pairs.seed_rc.all()
    for n in (t_len, q_len):
        assert (n[:B] > 0).all() and (n[B:] == 0).any()
    assert (ext["T"].at & 3).unique().tolist() == [0, 1, 2, 3]
    got = P.run_streams(ext["T"], ext["Q"], NO_DROP, 128, DEEP, adaptive,
                        longest=int(reads.lengths.max()), with_steps=True)
    want = P.xdrop_plain(T.contiguous(), t_len, Q.contiguous(), q_len,
                         NO_DROP, 128, DEEP, adaptive, with_steps=True)
    assert torch.equal(got, want)
    assert (got[3] == DEEP).any() and (got[3] < DEEP).any()


def test_row_streams_read_back_the_rows():
    """Word rows as descriptors (row e at flat base 16 e stride, forwards,
    not complemented) give back each row up to its length, also for rows
    cut from a wider matrix."""
    g = torch.Generator().manual_seed(5)
    wide = torch.randint(-2**31, 2**31 - 1, (6, 9), generator=g,
                         dtype=torch.int64).to(torch.int32)
    Tw = wide[:, 2:7]
    lens = torch.tensor([0, 1, 16, 17, 79, 80], dtype=torch.int32)
    s = P.row_streams(Tw, lens)
    got = P.stream_rows(s, 80)
    bases = _bases(got.numpy())
    want = _bases(Tw.contiguous().numpy())
    for b in range(6):
        n = int(lens[b])
        np.testing.assert_array_equal(bases[b, :n], want[b, :n])
        assert not bases[b, n:].any()


class _CardLike(torch.Tensor):
    """A host tensor that says it lies on the card (its device stays the
    CPU)."""

    @property
    def is_cuda(self):
        return True


@pytest.mark.parametrize("case,launches", [
    ("short", [(5, False)]),
    ("long xdrop", [(5, True)]),
    ("long reads", [(2, True), (3, False)]),
])
def test_level_splits_by_key_on_the_card(case, launches, monkeypatch):
    """On the card a level runs in one int32-key launch while its reads
    and xdrop lie below INT32_KEY_EXTENT, in one long-key launch when
    xdrop needs it, and otherwise as a long-key launch of the extensions
    that need it and an int32-key launch of the rest, each result back at
    its extension."""
    E = P.INT32_KEY_EXTENT
    lens = torch.tensor([3, E, 7, E + 5, 11], dtype=torch.int32)
    other = torch.tensor([4, 9, 8, 2, 1], dtype=torch.int32)
    words = torch.zeros(4, dtype=torch.int32)
    at = torch.arange(5, dtype=torch.int64) * 40
    if case == "short":
        lens = lens % 100
    ts = P.Streams(words, at.as_subclass(_CardLike),
                   lens.as_subclass(_CardLike))
    qs = P.Streams(words, at.as_subclass(_CardLike),
                   other.as_subclass(_CardLike))
    made = []

    def launch(ts, qs, xdrop, W, cap, adaptive, with_steps=False,
               long_key=False):
        made.append((len(ts.len), long_key))
        n = torch.as_tensor(ts.len).to(torch.int32)
        return torch.stack([n, (torch.as_tensor(ts.at) >> 3).to(torch.int32),
                            torch.full_like(n, int(long_key))])

    monkeypatch.setattr(P, "launch_streams", launch)
    ulog.reset()
    xdrop = E if case == "long xdrop" else 7
    out = P.run_streams(ts, qs, xdrop, 128, P.NO_CAP, False,
                        longest=int(lens.max()))
    assert made == launches
    assert out[0].tolist() == lens.tolist()
    assert out[1].tolist() == (at >> 3).tolist()
    if case == "long reads":
        assert out[2].tolist() == [0, 1, 0, 1, 0]
        assert ulog.COUNTS["sync.align"] == 2
    else:
        assert "sync.align" not in ulog.COUNTS


def test_slice_matches_seed_extend_batch():
    """Prep, the adaptive-band extension and the combine of the port
    (_extend_pairs) against bella_tpu's fused _seed_extend_batch."""
    k, reads, pairs = _case("k17")
    sel = np.arange(40)
    ref_reads = RefReadSet(list(reads.names), reads.codes, reads.offsets)
    mat, lens = RX.pad_reads(ref_reads)
    p = {f: jnp.asarray(getattr(pairs, f)[sel].astype(np.int32))
         for f in ("read_h", "read_v", "pos_h", "pos_v")}
    ref = RX._seed_extend_batch(
        jnp.asarray(mat), jnp.asarray(lens), p["read_h"], p["read_v"],
        p["pos_h"], p["pos_v"], jnp.asarray(pairs.seed_rc[sel]),
        jnp.ones(len(sel), bool), 25, kmer_size=k, band=32, max_steps=0)
    rd = X._upload_reads(reads, "cpu")
    pair_len = np.maximum(reads.lengths[pairs.read_h],
                          reads.lengths[pairs.read_v])
    got = X._extend_pairs(rd, pairs, sel, pair_len, 25, k, 32, 0, True, 16)
    np.testing.assert_array_equal(got, np.asarray(ref))


def test_prep_checks_inputs():
    k, reads, pairs, _ = _port("k17")
    rd = X._upload_reads(reads, "cpu")
    blk = X._pair_block(pairs, np.arange(4), "cpu")
    with pytest.raises(ValueError):  # the kernel launcher takes CUDA tensors
        X.launch_prep(rd, blk, k, 3008)
    with pytest.raises(ValueError):  # a width that is no multiple of 16
        X.prepare_batch(rd, blk, k, 3001)
    with pytest.raises(ValueError):  # int64 pair block
        X.prepare_batch(rd, blk.long(), k, 3008)


def test_plain_prep_of_an_empty_batch():
    k, reads, pairs, _ = _port("k17")
    rd = X._upload_reads(reads, "cpu")
    got = X.prepare_batch(rd, X._pair_block(pairs, np.arange(0), "cpu"), k,
                          64)
    assert got["T"].shape == got["Q"].shape == (0, 4)
    for key in ("t_len", "q_len", "seed_end_h", "seed_end_v"):
        assert got[key].shape == (0,) and got[key].dtype == torch.int32


def test_cpu_upload_packs_on_the_host(monkeypatch):
    _, reads, _ = _case("k17")
    calls = []

    def spy(r):
        calls.append(r)
        return pack(r)

    pack = X.pack_words_ragged
    monkeypatch.setattr(X, "pack_words_ragged", spy)
    ulog.reset()
    rd = X._upload_reads(reads, "cpu")
    flat, off_w = pack(reads)
    assert calls == [reads]
    assert torch.equal(rd.words, torch.from_numpy(flat.view(np.int32)))
    assert torch.equal(rd.off_w, torch.from_numpy(off_w.astype(np.int64)))
    assert torch.equal(rd.lens, torch.from_numpy(reads.lengths))
    assert "align.packed_reads" not in ulog.COUNTS
    assert "launch.pack_ragged" not in ulog.COUNTS


class _OnCard(torch.Tensor):
    """A host tensor that reports itself on the card."""

    @property
    def is_cuda(self):
        return True

    @property
    def device(self):
        return torch.device("cuda", 0)


def test_prep_on_card_raises_when_the_kernel_cannot_be_built(monkeypatch):
    k, reads, pairs, _ = _port("k17")
    rd = X._upload_reads(reads, "cpu")
    card = X._Reads(*(t.as_subclass(_OnCard)
                      for t in (rd.words, rd.off_w, rd.lens)))
    blk = X._pair_block(pairs, np.arange(4), "cpu").as_subclass(_OnCard)

    def broken(source):
        raise RuntimeError(f"nvcc failed building {source}")

    def plain(*a, **kw):
        raise AssertionError("took the plain version for a card tensor")

    monkeypatch.setattr(_build, "build", broken)
    monkeypatch.setattr(X, "prepare_batch_plain", plain)
    monkeypatch.setattr(X, "stream_rows", plain)
    before = _build.launches()["ext_prep"]
    with pytest.raises(RuntimeError, match="xdrop.cu"):
        X.prepare_batch(card, blk, k, 3008)
    assert _build.launches()["ext_prep"] == before
