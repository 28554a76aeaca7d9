"""Batched banded x-drop seed-and-extend: the alignment loop and the
adaptive-band kernel K2.

Counterpart of ``bella_tpu/align/xdrop.py``: ``align_candidates`` on its
packed-word path (the static-band kernel, the 2x-band rescue cascade, the
drift predictor and the adaptive exactness tail, and under
``--selfcheck`` the check of the first pass against K2) or, with
``aligner_backend="jax"``, on its adaptive-band path (K2 at
``band_width`` on every pair), on one device or data-parallel over a
shard group (its mesh branch); and the host helpers ``pad_reads`` and
``pack_words``.

``extend_batch`` is the adaptive-band extension (the band offset follows
the running argmax) that ``bella_tpu`` runs as a ``lax.while_loop``. Here
it is ``csrc/xdrop.cu`` in its adaptive mode (kernel K2); as a loop of
torch ops it would cost several launches per antidiagonal. Its plain
version, ``extend_batch_plain``, is what CPU tensors take.

Each extension's two streams are descriptors on the ragged word stream
of the reads (``extension_streams``: the read, start, direction and
complement of each, and its length, from the pair block and the reads'
lengths), which K1 and K2 read straight from the reads' words: on the card
a whole level of pairs (the first pass, each cascade level, the tail, the
adaptive pass) is one pair block, one launch and one download. The plain
versions take ``align_batch`` pairs at a time, the streams gathered into
rows. ``prepare_batch`` materialises a batch's streams as rows (kernel K3,
``csrc/xdrop.cu``, on CUDA tensors; ``prepare_batch_plain`` on CPU
tensors), for the tests and ``chip_smoke.py``. The barrel shifts of the TPU path
exist because TPU gathers are slow and are not ported, nor are the pow4
length tiers and batch buckets (compile-variant caps) or the prewarm
threads. With the default step cap no extension's cap binds (it is at
least t_len + q_len), so dropping the tiers changes no result.
"""

from __future__ import annotations

import dataclasses
import sys
from typing import Optional

import numpy as np
import torch

from bella_tpu_torch.align.pallas_xdrop import (
    NO_CAP, Streams, pack_words as _pack_rows, round_band, run_streams,
    run_xdrop, static_step_cap, stream_rows, xdrop_plain, _check,
)
from bella_tpu_torch.utils.log import count, log, span


# ----------------------------------------------------------------------
# Kernel K2: adaptive-band extension
# ----------------------------------------------------------------------


def _adaptive_args(T, band: int, max_steps: int):
    return int(band), int(max_steps) if max_steps > 0 else 2 * T.shape[1]


def extend_batch(T, t_len, Q, q_len, xdrop: int, band: int = 128,
                 max_steps: int = 0) -> dict:
    """One-direction adaptive-band x-drop extension (the contract of
    bella_tpu.align.xdrop.extend_batch): T, Q (B, L) base codes, t_len,
    q_len (B,) int32; the band is used as given (not rounded); the step
    cap is exactly max_steps (<= 0 means 2 * L). Returns dict(score,
    t_end, q_end). Packs the codes into words and launches K2 for CUDA
    tensors."""
    W, cap = _adaptive_args(T, band, max_steps)
    out = run_xdrop(_pack_rows(T), t_len, _pack_rows(Q), q_len, xdrop, W,
                    cap, True)
    return dict(score=out[0], t_end=out[1], q_end=out[2])


def extend_batch_plain(T, t_len, Q, q_len, xdrop: int, band: int = 128,
                       max_steps: int = 0) -> dict:
    """The plain version of extend_batch, on any device."""
    W, cap = _adaptive_args(T, band, max_steps)
    Tw, Qw = _pack_rows(T), _pack_rows(Q)
    _check(Tw, t_len, Qw, q_len, int(xdrop), W)
    out = xdrop_plain(Tw, t_len, Qw, q_len, int(xdrop), W, cap, True)
    return dict(score=out[0], t_end=out[1], q_end=out[2])


# ----------------------------------------------------------------------
# Seed-and-extend loop
# ----------------------------------------------------------------------


@dataclasses.dataclass
class AlignmentResult:
    """Extended seeds and scores per candidate pair; H coordinates are on
    the reverse-complemented H read when strand_rc. rescue_levels lists
    the cascade's (band, pairs re-extended) and tail_pairs the indices of
    the pairs the adaptive exactness tail re-extended (both empty on the
    adaptive-band path)."""

    score: np.ndarray   # (P,) int32
    beg_h: np.ndarray
    end_h: np.ndarray
    beg_v: np.ndarray
    end_v: np.ndarray
    strand_rc: np.ndarray  # (P,) bool
    rescue_levels: tuple = ()
    tail_pairs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0, np.int64))


PAD_CHAR = 127  # pad_reads' fill: never equals a 2-bit base code


def pad_reads(reads, bucket: int = 512):
    """Host: ReadSet -> ((R, Lmax) int8 code matrix, PAD_CHAR beyond each
    read; (R,) int32 lengths), Lmax rounded up to `bucket` (bella_tpu's
    pad_reads; align_candidates' first argument)."""
    lens = reads.lengths.astype(np.int32)
    lmax = (-(-int(lens.max()) // bucket) * bucket if len(lens)
            else bucket)
    mat = np.full((reads.num_reads, lmax), PAD_CHAR, np.int8)
    for r in range(reads.num_reads):
        s, e = reads.offsets[r], reads.offsets[r + 1]
        mat[r, :e - s] = reads.codes[s:e]
    return mat, lens


def _pack_bytes(c: np.ndarray) -> np.ndarray:
    """(..., 4n) uint8 codes 0..3 -> (..., n) uint32, 16 bases a word
    least significant first: two pairwise byte combines and a
    little-endian uint32 view."""
    c = c[..., 0::2] | (c[..., 1::2] << 2)
    c = np.ascontiguousarray(c[..., 0::2] | (c[..., 1::2] << 4))
    if sys.byteorder != "little":  # pragma: no cover
        return c.reshape(c.shape[:-1] + (-1, 4)).astype(np.uint32) @ (
            np.uint32(1) << (8 * np.arange(4, dtype=np.uint32)))
    return c.view(np.uint32)


def pack_words(mat: np.ndarray) -> np.ndarray:
    """Host: (R, L) codes -> (R, L/16) uint32, 16 bases a word least
    significant first (bella_tpu's pack_words; L a multiple of 16). Codes
    are taken & 3, so PAD_CHAR becomes 'A': every consumer masks by
    lengths. The device version is pallas_xdrop.pack_words."""
    if mat.dtype.itemsize != 1:  # wider codes: convert, never reinterpret
        mat = mat.astype(np.int8)
    return _pack_bytes(np.ascontiguousarray(mat).view(np.uint8) & 3)


def pack_words_ragged(reads):
    """Host: ReadSet -> (flat_words, word_offsets): each read's codes
    packed 16 per uint32 word (least significant first), each read
    starting on a word boundary, tail fill 'A' (consumers mask by
    lengths). Same layout as bella_tpu.align.xdrop.pack_words_ragged."""
    lens = reads.lengths.astype(np.int64)
    nw = -(-lens // 16)
    off_w = np.zeros(len(lens) + 1, np.int64)
    np.cumsum(nw, out=off_w[1:])
    buf = np.zeros(int(off_w[-1]) * 16, np.uint8)
    src = reads.codes
    soff = reads.offsets
    for r in range(len(lens)):
        d = int(off_w[r]) * 16
        n = int(lens[r])
        buf[d:d + n] = src[int(soff[r]):int(soff[r]) + n]
    return _pack_bytes(buf), off_w[:-1].astype(np.int32)


@dataclasses.dataclass
class _Reads:
    """The read set on the device: ragged words, word offsets, lengths."""

    words: torch.Tensor    # (total_words,) int32 (uint32 bit patterns)
    off_w: torch.Tensor    # (R,) int64
    lens: torch.Tensor     # (R,) int64


def _upload(a: np.ndarray, device) -> torch.Tensor:
    """a on `device`: from pageable memory, so on a card the host waits
    for the copy (counted as sync.align)."""
    t = torch.from_numpy(a).to(device)
    if t.is_cuda:
        count("sync.align")
    return t


def _download(t: torch.Tensor) -> np.ndarray:
    """t on the host: a wait for the card where t lies on it (counted as
    sync.align)."""
    if t.is_cuda:
        count("sync.align")
    return t.cpu().numpy()


def _upload_reads(reads, device) -> _Reads:
    with span("align.upload"):
        flat, off_w = pack_words_ragged(reads)
        if flat.size == 0:
            flat = np.zeros(1, np.uint32)
        return _Reads(
            words=_upload(flat.view(np.int32).copy(), device),
            off_w=_upload(off_w.astype(np.int64), device),
            lens=_upload(reads.lengths.astype(np.int64), device),
        )


def _pair_block(pairs, rows: np.ndarray, device) -> torch.Tensor:
    """The (5, B) int32 block of pairs `rows` on `device`, rows read_h,
    read_v, pos_h, pos_v, seed_rc: one upload a launch (bella_tpu's
    _pair_block without its row of batch-padding flags)."""
    blk = np.stack([pairs.read_h[rows], pairs.read_v[rows],
                    pairs.pos_h[rows], pairs.pos_v[rows],
                    pairs.seed_rc[rows]]).astype(np.int32)
    return _upload(blk, device)


def _check_prep(rd: _Reads, blk, L: int) -> None:
    """Raise on inputs the prep kernel does not take."""
    if (blk.dim() != 2 or blk.shape[0] != 5 or blk.dtype != torch.int32
            or not blk.is_contiguous()):
        raise ValueError("the pair block must be a contiguous (5, B) int32 "
                         f"tensor, got {blk.dtype} {tuple(blk.shape)}")
    if L < 16 or L % 16:
        raise ValueError(f"batch width {L} is not a positive multiple of 16")
    for name, t, dtype in (("words", rd.words, torch.int32),
                           ("off_w", rd.off_w, torch.int64),
                           ("lens", rd.lens, torch.int64)):
        if t.dim() != 1 or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(f"read {name} must be a contiguous 1-D {dtype} "
                             "tensor")
        if t.device != blk.device:
            raise ValueError(f"read {name} on {t.device}, the pair block on "
                             f"{blk.device}")


def extension_streams(rd: _Reads, blk, k: int) -> dict:
    """The extensions of the (5, B) pair block on the reads' words, by
    torch ops on its device (what K3 derives for each of its rows): T and
    Q, Streams of 2B extensions, the left ones (lt against lq) then the
    right ones (rt against rq); seed_end_h, seed_end_v (B,) int32. The
    strand correction of each seed, then left = the reversed prefix up to
    the seed's end, right = the suffix after it, of H (reverse-complemented
    where the seed is: H[x] = 3 - h[len_h - 1 - x]) and of V."""
    bh, bv, ph, pv, rc = blk.to(torch.int64)
    rc = rc != 0
    len_h, len_v = rd.lens[bh], rd.lens[bv]
    seh = torch.where(rc, len_h - ph - k, ph) + k  # seed end on H
    sev = pv + k                                   # seed end on V
    at_h, at_v = 64 * rd.off_w[bh], 64 * rd.off_w[bv]
    # descriptors 4 start + 2 (backwards) + (complemented)
    t_at = torch.cat([
        at_h + torch.where(rc, 4 * (len_h - seh) + 1, 4 * (seh - 1) + 2),
        at_h + torch.where(rc, 4 * (len_h - 1 - seh) + 3, 4 * seh)])
    q_at = torch.cat([at_v + 4 * (sev - 1) + 2, at_v + 4 * sev])
    i32 = torch.int32
    t_len = torch.cat([seh, len_h - seh]).to(i32)
    q_len = torch.cat([sev, len_v - sev]).to(i32)
    return dict(T=Streams(rd.words, t_at, t_len),
                Q=Streams(rd.words, q_at, q_len),
                seed_end_h=seh.to(i32), seed_end_v=sev.to(i32))


def prepare_batch_plain(rd: _Reads, blk, k: int, L: int) -> dict:
    """The plain version of prepare_batch, on any device: the batch's
    extension_streams gathered into rows (stream_rows), row for row as K3
    writes them."""
    _check_prep(rd, blk, L)
    ext = extension_streams(rd, blk, k)
    return dict(T=stream_rows(ext["T"], L), Q=stream_rows(ext["Q"], L),
                t_len=ext["T"].len, q_len=ext["Q"].len,
                seed_end_h=ext["seed_end_h"], seed_end_v=ext["seed_end_v"],
                L=L)


def launch_prep(rd: _Reads, blk, k: int, L: int) -> dict:
    """Launch K3 (csrc/xdrop.cu) on CUDA tensors, on the current stream of
    their card. Raises if the library cannot be built or the launch
    fails; never falls back to the plain version."""
    import ctypes

    from bella_tpu_torch.align import _build

    if not blk.is_cuda:
        raise ValueError("launch_prep takes CUDA tensors")
    _check_prep(rd, blk, L)
    lib = _build.xdrop_lib()
    B, Wp, dev = blk.shape[1], L // 16, blk.device

    def empty(*shape):
        return torch.empty(shape, dtype=torch.int32, device=dev)

    out = dict(T=empty(2 * B, Wp), Q=empty(2 * B, Wp), t_len=empty(2 * B),
               q_len=empty(2 * B), seed_end_h=empty(B), seed_end_v=empty(B),
               L=L)
    if B == 0:
        return out

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bella_prep_launch(
            ptr(rd.words), rd.words.numel(), ptr(rd.off_w), ptr(rd.lens),
            ptr(blk), B, int(k), Wp, ptr(out["T"]), ptr(out["Q"]),
            ptr(out["t_len"]), ptr(out["q_len"]), ptr(out["seed_end_h"]),
            ptr(out["seed_end_v"]), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(f"extension prep kernel launch failed: CUDA "
                           f"error {rc}")
    count("launch.ext_prep")
    return out


def prepare_batch(rd: _Reads, blk, k: int, L: int) -> dict:
    """The extension streams of one batch (what bella_tpu's
    _seed_extend_batch_pallas computes before its kernel): blk is the
    (5, B) int32 pair block (_pair_block), L the batch width in bases (a
    multiple of 16 that fits every read of the batch). Returns T = [lt;
    rt] and Q = [lq; rq], each (2B, L/16) int32 words, 'A' beyond each
    stream's length; t_len, q_len (2B,) int32; seed_end_h, seed_end_v
    (B,) int32; L. K3 for CUDA tensors, the plain version for CPU
    tensors, an error for anything else."""
    if blk.is_cuda:
        return launch_prep(rd, blk, k, L)
    if blk.device.type == "cpu":
        return prepare_batch_plain(rd, blk, k, L)
    raise ValueError(f"no extension prep kernel for device {blk.device}")


def _combine_extensions(ext, left, right) -> torch.Tensor:
    """(6, B) int32 rows score/beg_h/end_h/beg_v/end_v/drift; drift is the
    PER-DIRECTION max |t_end - q_end| (band saturation is a property of
    one extension)."""
    drift = torch.maximum(
        (left[1] - left[2]).abs(), (right[1] - right[2]).abs()
    )
    return torch.stack([
        left[0] + right[0],
        ext["seed_end_h"] - left[1],
        ext["seed_end_h"] + right[1],
        ext["seed_end_v"] - left[2],
        ext["seed_end_v"] + right[2],
        drift,
    ]).to(torch.int32)


def extension_batches(rd: _Reads, pairs, sel: np.ndarray,
                      pair_len: np.ndarray, k: int, batch_size: int):
    """Yield (idx, ext) per batch of pairs sel[idx], batches taken in
    order of pair length so each batch's word width fits its reads: the
    streams materialised a batch at a time, against which chip_smoke.py
    and the tests hold and time the one launch a level of _extend_pairs.
    ext is prepare_batch's: T, Q, t_len, q_len, the left and right
    extensions stacked, so both directions of a batch go through one
    launch of 2B extensions; the seed ends; and L, the batch's width in
    bases, from the host's pair_len (max of the two read lengths of each
    pair)."""
    order = np.argsort(pair_len[sel], kind="stable")
    dev = rd.lens.device
    for s in range(0, len(sel), batch_size):
        idx = order[s:s + batch_size]
        rows = sel[idx]
        L = max(16, -(-int(pair_len[rows].max()) // 16) * 16)
        yield idx, prepare_batch(rd, _pair_block(pairs, rows, dev), k, L)


def _extend_pairs(rd: _Reads, pairs, sel: np.ndarray, pair_len: np.ndarray,
                  xdrop: int, k: int, band: int, max_steps: int,
                  adaptive: bool, batch_size: int) -> np.ndarray:
    """(6, len(sel)) int32 extension rows for pairs `sel`: K1 at the
    static band, or K2 at the adaptive band, on both extensions of every
    pair. On the card the pairs go up as one pair block and run as one
    launch (two where some extension needs the long key), in one
    longest-first order, and come back in one download; the plain
    versions take batch_size pairs at a time in order of pair length, so
    that their (B, W) tensors stay bounded (an extension's result does not
    depend on its batch). With max_steps <= 0 no extension's step cap
    binds."""
    out = np.zeros((6, len(sel)), np.int32)
    if not len(sel):
        return out
    if adaptive:
        W, cap = int(band), max_steps if max_steps > 0 else NO_CAP
    else:
        W = round_band(band)
        cap = static_step_cap(max_steps) if max_steps > 0 else NO_CAP
    dev = rd.lens.device
    if rd.lens.is_cuda:
        batches = [np.arange(len(sel))]
    else:
        order = np.argsort(pair_len[sel], kind="stable")
        batches = [order[s:s + batch_size]
                   for s in range(0, len(sel), batch_size)]
    parts = []
    for idx in batches:
        with span("align.batch"):
            rows = sel[idx]
            ext = extension_streams(rd, _pair_block(pairs, rows, dev), k)
            res = run_streams(ext["T"], ext["Q"], xdrop, W, cap, adaptive,
                              longest=int(pair_len[rows].max()))
            B = len(idx)
            parts.append(_combine_extensions(ext, res[:, :B], res[:, B:]))
    with span("align.collect"):
        out[:, np.concatenate(batches)] = _download(torch.cat(parts, dim=1))
    return out


def align_candidates(
    reads_padded: Optional[np.ndarray],
    read_lengths: np.ndarray,
    pairs,
    config,
    batch_size: int = 0,
    reads=None,
    device="cuda",
    mesh=None,
) -> AlignmentResult:
    """Align all candidate pairs (the contract of
    bella_tpu.align.xdrop.align_candidates). The static-band path
    (aligner_backend "auto" or "pallas"): the static-band kernel at
    config.pallas_band, then the 2x-band rescue cascade with the drift
    predictor up to rescue_ceiling, then the adaptive-band exactness tail
    at config.band_width. The adaptive-band path (any other backend, e.g.
    "jax"): the adaptive-band kernel at config.band_width on every pair
    (config.adaptive_aligner).

    reads: the ReadSet (or None with reads_padded, an (R, Lmax) code
    matrix padded beyond read_lengths). device defaults to "cuda"; the
    CPU runs the kernels' plain versions. mesh: a ShardGroup over which
    the pairs run data-parallel (reads uploaded once to each distinct
    device, one share of the pairs a shard, each share through the whole
    driver on its device); a pair's result does not depend on its share,
    so the result is the single-device one."""
    from bella_tpu_torch.config import resolve_device
    from bella_tpu_torch.io.fastq import ReadSet

    dev = resolve_device(device) if mesh is None else None
    P = pairs.num_pairs
    if P == 0:
        z = np.zeros(0, np.int32)
        return AlignmentResult(z, z, z, z, z, np.zeros(0, bool))
    read_lengths = np.asarray(read_lengths)
    if reads is None:
        codes = [np.asarray(reads_padded[r, :int(n)], np.uint8)
                 for r, n in enumerate(read_lengths)]
        offsets = np.zeros(len(codes) + 1, np.int64)
        np.cumsum(read_lengths.astype(np.int64), out=offsets[1:])
        reads = ReadSet([""] * len(codes), np.concatenate(codes), offsets)
    if batch_size <= 0:
        batch_size = int(config.align_batch)
    pair_len = np.maximum(read_lengths[pairs.read_h], read_lengths[pairs.read_v])
    if mesh is None:
        shares = [_align_share(_upload_reads(reads, dev), pairs,
                               np.arange(P), pair_len, config, batch_size)]
    else:
        uploaded = {str(d): _upload_reads(reads, d) for d in mesh.devices}

        def share(dev, shard):
            return _align_share(uploaded[str(dev)], pairs,
                                np.arange(shard, P, mesh.size), pair_len,
                                config, batch_size)

        shares = mesh.map(share, mesh.shards)
        if mesh.process_group is not None:
            shares = _gather_shares(mesh, shares[0])
    out = np.zeros((5, P), np.int32)
    levels: dict = {}
    tails, rescued = [], 0
    for sel, rows, level_counts, tail, n_rescued in shares:
        out[:, sel] = rows
        for band, cnt in level_counts:
            levels[band] = levels.get(band, 0) + cnt
        tails.append(tail)
        rescued += n_rescued
    tail = np.sort(np.concatenate(tails)).astype(np.int64)
    level_counts = sorted(levels.items())
    if rescued and config.band_rescue:
        log("bandDriftRescued",
            f"{rescued} pairs re-extended (band cascade "
            + " ".join(f"{b}:{n}" for b, n in level_counts) + ")"
            + (f"; {len(tail)} drift-limited pairs resolved via the "
               "adaptive-band kernel; 0 unresolved" if len(tail) else ""))
    elif rescued:
        log("bandDriftSaturated",
            f"{rescued} pairs at the static band edge "
            f"(band {int(config.pallas_band)}); band_rescue is off")
    return AlignmentResult(*out, pairs.seed_rc.copy(), tuple(level_counts),
                           tail)


def _gather_shares(mesh, share) -> list:
    """Every rank's share result, on every rank."""
    sel, rows, level_counts, tail, rescued = share
    dev = mesh.devices[0]
    got = _download(mesh.gather([_upload(
        np.vstack([sel, rows]).T.astype(np.int64), dev)]))
    lv = _download(mesh.gather([_upload(np.array(
        [[b, c] for b, c in level_counts] + [[0, rescued]],
        np.int64).reshape(-1, 2), dev)]))
    tl = _download(mesh.gather([_upload(tail.astype(np.int64), dev)]))
    return [(got[:, 0], got[:, 1:].T.astype(np.int32),
             [(int(b), int(c)) for b, c in lv if b > 0], tl,
             int(lv[lv[:, 0] == 0, 1].sum()))]


def _align_share(rd: _Reads, pairs, sel: np.ndarray, pair_len, config,
                 batch_size: int):
    """The whole driver on the pairs `sel` (first pass, --selfcheck's
    check, cascade, tail; or the adaptive-band pass alone) on rd's
    device. Returns (sel; (5, len(sel)) int32 score, beg_h, end_h, beg_v,
    end_v; the cascade's (band, pairs); the tail's pair indices; the pairs
    the static band saturated)."""
    k = int(config.kmer_size)
    xdrop = int(config.xdrop)
    pallas_band = int(config.pallas_band)
    max_steps = int(config.max_steps or 0)
    if config.adaptive_aligner:
        arr = _extend_pairs(rd, pairs, sel, pair_len, xdrop, k,
                            int(config.band_width), max_steps, True,
                            batch_size)
        return sel, arr[:5], [], np.zeros(0, np.int64), 0

    def extend(loc, band, steps):
        return _extend_pairs(rd, pairs, sel[loc], pair_len, xdrop, k, band,
                             steps, False, batch_size)

    arr = extend(np.arange(len(sel)), pallas_band, max_steps)
    score, beg_h, end_h, beg_v, end_v, sat = (arr[r].copy() for r in range(6))
    if config.selfcheck:
        _align_check(rd, pairs, pair_len, config, score, max_steps,
                     batch_size, sel)

    # runtime guard of the static centered band: a pair whose extension
    # drifted ~W/2 off the diagonal hit the band edge and re-extends at 2x
    # band, level by level up to the ceiling; scores are the max over the
    # bands visited (x-drop is not monotone in band width). Indices below
    # are positions in sel.
    sat_idx = np.nonzero(sat >= pallas_band // 2 - 2)[0]
    rescued = len(sat_idx)
    level_counts = []
    tail = np.zeros(0, np.int64)
    if len(sat_idx) and config.band_rescue:
        with span("align.cascade"):
            ceiling = max(int(config.rescue_ceiling), 2 * pallas_band)
            rescue_band = 2 * pallas_band
            sat_level = sat.copy()
            due = np.full(len(sat_idx), rescue_band, np.int64)
            if config.rescue_predict:
                e_obs = np.maximum(
                    np.maximum(end_h[sat_idx] - beg_h[sat_idx],
                               end_v[sat_idx] - beg_v[sat_idx]),
                    1,
                ).astype(np.float64)
                e_pred = np.maximum(
                    pairs.overlap_est[sel[sat_idx]].astype(np.float64), e_obs
                ) if pairs.overlap_est.size else e_obs
                due = _predict_due(sat[sat_idx], e_obs, e_pred, rescue_band,
                                   ceiling)
            while len(sat_idx) and rescue_band <= ceiling:
                at_level = due <= rescue_band
                cur = sat_idx[at_level]
                if not len(cur):
                    rescue_band *= 2
                    continue
                level_counts.append((rescue_band, len(cur)))
                res = extend(cur, rescue_band, max_steps)
                sat_level[cur] = res[5]
                better = res[0] >= score[cur]
                upd = cur[better]
                score[upd], beg_h[upd], end_h[upd] = res[0, better], res[1, better], res[2, better]
                beg_v[upd], end_v[upd], sat[upd] = res[3, better], res[4, better], res[5, better]
                # pairs extended at THIS level and still saturated walk on;
                # predicted-later pairs stay pending untouched
                still = at_level & (sat_level[sat_idx] >= rescue_band // 2 - 2)
                count("cascade.extended", len(cur))
                count("cascade.settled", len(cur) - int(still.sum()))
                keep = still | ~at_level
                due = np.where(still, rescue_band * 2, due)[keep]
                sat_idx = sat_idx[keep]
                rescue_band *= 2
        if len(sat_idx):
            with span("align.tail"):
                _adaptive_tail_rescue(
                    rd, pairs, sel, sat_idx, pair_len, config, score, beg_h,
                    end_h, beg_v, end_v, batch_size,
                )
            tail = sel[sat_idx]
    return (sel, np.stack([score, beg_h, end_h, beg_v, end_v]),
            level_counts, tail, rescued)


def _align_check(rd: _Reads, pairs, pair_len, config, score, max_steps: int,
                 batch_size: int, sel=None) -> tuple:
    """--selfcheck's alignment check (bella_tpu's, under its selfcheck
    switch): the batch of pairs with the shortest overlap estimates
    (among `sel`, every pair when None; score[j] is pair sel[j]'s)
    re-extends through the adaptive-band kernel K2 at band_width, and
    its scores are held against the first pass's (K1 at the static band).
    A broken kernel shows as widespread divergence; band trajectories
    differ by more than xdrop on few pairs, so more than
    max(n // 20, 2) such pairs raise SelfCheckError. Returns (pairs
    sampled, max |score difference|, pairs beyond xdrop)."""
    from bella_tpu_torch.utils.selfcheck import SelfCheckError

    if sel is None:
        sel = np.arange(pairs.num_pairs)
    key = (pairs.overlap_est if pairs.overlap_est.size
           and pairs.overlap_est.max() > 0 else pair_len)[sel]
    loc = np.sort(np.argsort(key, kind="stable")[:min(len(sel), batch_size)])
    ref = _extend_pairs(rd, pairs, sel[loc], pair_len, int(config.xdrop),
                        int(config.kmer_size), int(config.band_width),
                        max_steps, True, batch_size)[0]
    diff = np.abs(ref.astype(np.int64) - score[loc])
    bad = int((diff > int(config.xdrop)).sum())
    worst = int(diff.max()) if len(loc) else 0
    log("alignCheck",
        f"sampled {len(loc)} pairs: max |dScore| {worst}, {bad} beyond "
        "xdrop")
    if bad > max(len(loc) // 20, 2):
        raise SelfCheckError(
            f"aligner consistency check failed: {bad}/{len(loc)} pairs "
            "diverge beyond xdrop between the static-band kernel K1 and "
            "the adaptive-band kernel K2")
    return len(loc), worst, bad


def _predict_due(sat_vals, e_obs, e_pred, base, ceiling):
    """Terminal-band prediction for the rescue cascade (the reference's
    bella_tpu.align.xdrop._predict_due): early-truncated pairs (e_obs well
    short of the overlap estimate) extrapolate their drift rate over the
    full overlap and route straight to the smallest ladder band whose
    half-width exceeds it; censored pairs keep the doubling walk."""
    sat_f = np.asarray(sat_vals, np.float64)
    censored = e_obs >= 0.75 * e_pred
    d_pred = np.where(censored, sat_f, sat_f * (e_pred / e_obs))
    # smallest ladder band B = base * 2^j with B/2 - 2 > d_pred
    mult = np.maximum((2.0 * d_pred + 6.0) / base, 1.0)
    due = base * (1 << np.ceil(np.log2(mult)).astype(np.int64))
    # clamp to the top ladder level so clamped pairs still meet a level
    top = base << max(0, int(np.floor(np.log2(ceiling / base))))
    return np.minimum(due, top)


def _adaptive_tail_rescue(rd: _Reads, pairs, sel, sat_idx, pair_len, config,
                          score, beg_h, end_h, beg_v, end_v,
                          batch_size: int) -> None:
    """Exactness tail of the cascade: pairs sel[sat_idx], still saturated
    after the widest static band, re-extend through the adaptive-band
    kernel K2 at config.band_width (its band follows the running argmax,
    so it tracks drift indefinitely); the higher score wins. The result
    arrays are indexed by position in sel."""
    res = _extend_pairs(rd, pairs, sel[sat_idx], pair_len, int(config.xdrop),
                        int(config.kmer_size), int(config.band_width), 0,
                        True, batch_size)
    better = res[0] >= score[sat_idx]
    upd = sat_idx[better]
    score[upd], beg_h[upd], end_h[upd] = res[0, better], res[1, better], res[2, better]
    beg_v[upd], end_v[upd] = res[3, better], res[4, better]
