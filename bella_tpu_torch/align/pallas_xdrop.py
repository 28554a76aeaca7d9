"""Static-band x-drop extension: kernel K1 and its plain version.

Counterpart of ``bella_tpu/align/pallas_xdrop.py`` (the name is kept so
the two are found side by side). The TPU kernel ``_kernel`` behind
``extend_batch_pallas_packed`` and ``extend_batch_pallas`` becomes the
CUDA kernel ``csrc/xdrop.cu`` in its static mode: a warp per extension
(a few at W > 512) with the band in registers, on a persistent grid that
takes extensions longest first (see the source's note for what bounds it
on the H100). ``extend_batch_packed`` and
``extend_batch_chars`` keep the contracts of the two Pallas entries.
Launches whose lengths and xdrop are below ``INT32_KEY_EXTENT`` run the
kernel's int32-key instantiation; longer ones (to ``MAX_EXTENT``) its
long-key instantiation, with the same results.

The kernel reads each extension's bases through a descriptor on a flat
word stream (``Streams``): the alignment driver gives it the reads' own
words (``run_streams``), so no extension is materialised; the entries on
word rows give it the rows as streams (``row_streams``). Both go through
one launcher, ``launch_streams``.

A wrapper launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain PyTorch version (``xdrop_plain``, a loop over
antidiagonals on (B, W) tensors; ``stream_rows`` gathers streams into
rows for it) only for tensors on the CPU.
"""

from __future__ import annotations

import dataclasses

import torch

from bella_tpu_torch.utils.log import count

NINF = -(1 << 20)
MATCH, MISMATCH, GAP = 1, -1, -1
MAX_BAND = 4096            # lanes per block the kernel's reduction key holds
# Lengths and xdrop below INT32_KEY_EXTENT fit the kernel's int32 key
# (w * span + lane, w = value + d); at or above it the long-key
# instantiation runs, exact while w < 2^31: lengths and xdrop below
# MAX_EXTENT = 2^29 keep value + d <= 3 * 2^29.
INT32_KEY_EXTENT = 1 << 17
MAX_EXTENT = 1 << 29
# a step cap no extension reaches (t_len + q_len < 2 * MAX_EXTENT)
NO_CAP = 2 * MAX_EXTENT
_CHUNK = 128               # the compiled Pallas kernel's step granularity


def round_band(band: int) -> int:
    """The static kernel's band: a multiple of 128, at least 128."""
    return max(128, -(-int(band) // 128) * 128)


def static_step_cap(max_steps: int) -> int:
    """Step cap of the static kernel: whole 128-step chunks as the
    compiled Pallas kernel runs them, so never below max_steps."""
    return (-(-int(max_steps) // _CHUNK) + 1) * _CHUNK


def pack_words(chars: torch.Tensor) -> torch.Tensor:
    """(B, L) base codes -> (B, ceil(L/16)) int32 words, 16 bases per
    word least significant first (codes are taken & 3, so padding becomes
    'A'; every consumer masks by lengths). The int32 holds the uint32 bit
    pattern."""
    B, L = chars.shape
    Lp = -(-L // 16) * 16
    c = (chars.to(torch.int64) & 3)
    if Lp > L:
        c = torch.nn.functional.pad(c, (0, Lp - L))
    shifts = 2 * torch.arange(16, device=chars.device, dtype=torch.int64)
    w = (c.view(B, Lp // 16, 16) << shifts).sum(dim=2)
    return torch.where(w >= (1 << 31), w - (1 << 32), w).to(torch.int32)


def unpack_words(words: torch.Tensor) -> torch.Tensor:
    """(B, Wp) int32 words -> (B, 16 * Wp) uint8 base codes."""
    B, Wp = words.shape
    shifts = 2 * torch.arange(16, device=words.device, dtype=torch.int32)
    c = (words.to(torch.int32)[:, :, None] >> shifts) & 3
    return c.reshape(B, Wp * 16).to(torch.uint8)


def host_int(t: torch.Tensor) -> int:
    """int(t), counted as a host sync (sync.align) where t lies on the
    card: the host waits for the card to compute it."""
    if t.is_cuda:
        count("sync.align")
    return int(t)


def _check(Tw, t_len, Qw, q_len, xdrop: int, W: int) -> int:
    """Raise on inputs the kernel does not take; returns the longest
    length (0 for an empty batch)."""
    for name, t in (("T", Tw), ("Q", Qw)):
        if t.dim() != 2 or t.dtype != torch.int32 or t.stride(1) != 1:
            raise ValueError(f"{name} words must be a row-contiguous 2-D "
                             f"int32 tensor, got {t.dtype} {tuple(t.shape)}")
    B = Tw.shape[0]
    for name, t in (("t_len", t_len), ("q_len", q_len)):
        if t.shape != (B,) or t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous ({B},) int32 tensor")
    devs = {t.device for t in (Tw, t_len, Qw, q_len)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    if Qw.shape[0] != B:
        raise ValueError("T and Q must have the same number of rows")
    if not 2 <= W <= MAX_BAND:
        raise ValueError(f"band {W} outside [2, {MAX_BAND}]")
    if not 0 <= xdrop < MAX_EXTENT:
        raise ValueError(f"xdrop {xdrop} outside [0, {MAX_EXTENT})")
    if B:
        if (host_int(t_len.max()) > 16 * Tw.shape[1]
                or host_int(q_len.max()) > 16 * Qw.shape[1]):
            raise ValueError("a length exceeds its word row")
        if host_int(t_len.min()) < 0 or host_int(q_len.min()) < 0:
            raise ValueError("negative length")
        longest = max(host_int(t_len.max()), host_int(q_len.max()))
        if longest >= MAX_EXTENT:
            raise ValueError(f"lengths must be below {MAX_EXTENT}")
        return longest
    return 0


def needs_long_key(longest: int, xdrop: int) -> bool:
    """True when a launch with this longest length and xdrop must take the
    long-key instantiation."""
    return max(int(longest), int(xdrop)) >= INT32_KEY_EXTENT


def longest_first(t_len: torch.Tensor, q_len: torch.Tensor) -> torch.Tensor:
    """(B,) int32 order in which the kernel takes extensions: by
    t_len + q_len, longest first, ties in input order."""
    total = t_len.to(torch.int64) + q_len.to(torch.int64)
    return torch.argsort(total, descending=True, stable=True).to(torch.int32)


def resident_extensions(W: int, adaptive: bool) -> int:
    """Extensions the kernel runs at once at band W on the current CUDA
    device (its persistent grid's warp groups)."""
    from bella_tpu_torch.align import _build

    n = _build.xdrop_lib().bella_xdrop_slots(int(W), 1 if adaptive else 0)
    if n <= 0:
        raise RuntimeError(f"x-drop kernel occupancy query failed at W={W}")
    return n


@dataclasses.dataclass
class Streams:
    """B extension streams on a flat word stream (16 bases an int32 word,
    least significant first): stream e holds len[e] bases, and its base t
    is flat base a + t, or a - t where it runs backwards, complemented
    where flagged; at[e] = 4 a + 2 (backwards) + (complemented) is the
    kernel's descriptor."""

    words: torch.Tensor  # (n,) int32
    at: torch.Tensor     # (B,) int64
    len: torch.Tensor    # (B,) int32

    def take(self, idx) -> "Streams":
        return Streams(self.words, self.at[idx], self.len[idx])


def row_streams(Tw, t_len) -> Streams:
    """The rows of a (B, Wp) int32 word matrix (rows contiguous) as
    streams: row e is the stream at flat base 16 e stride, forwards, not
    complemented."""
    B, Wp = Tw.shape
    extent = (B - 1) * Tw.stride(0) + Wp if B else 0
    at = torch.arange(B, dtype=torch.int64, device=Tw.device)
    return Streams(Tw.as_strided((extent,), (1,)), at * (64 * Tw.stride(0)),
                   t_len)


def stream_rows(s: Streams, L: int) -> torch.Tensor:
    """(B, ceil(L/16)) int32 words of the streams s, 'A' beyond each
    length: one indexed gather per base, then packed (the plain version of
    the kernel's loads, and of the rows K3 writes)."""
    t = torch.arange(L, device=s.at.device, dtype=torch.int64)[None, :]
    step = torch.where((s.at & 2) != 0, -1, 1)
    pos = (s.at >> 2)[:, None] + step[:, None] * t
    ok = t < s.len[:, None]
    pos = torch.where(ok, pos, 0).clamp(0, 16 * s.words.numel() - 1)
    base = (s.words[pos >> 4] >> (2 * (pos & 15)).to(torch.int32)) & 3
    base = base ^ (3 * (s.at & 1).to(torch.int32))[:, None]
    return pack_words(torch.where(ok, base, 0))


def launch_streams(ts: Streams, qs: Streams, xdrop: int, W: int, cap: int,
                   adaptive: bool, with_steps: bool = False,
                   long_key: bool = False) -> torch.Tensor:
    """Launch csrc/xdrop.cu on streams of CUDA tensors, extension e
    running ts's stream e against qs's. Returns a (3, B) int32 tensor
    (score, t_end, q_end), with a fourth row of antidiagonal counts when
    with_steps. long_key selects the long-key instantiation. Raises if
    the library cannot be built or the launch fails; never falls back to
    the plain version. The kernel takes extensions in longest_first order
    from a counter zeroed here, and writes each result at its extension's
    index."""
    import ctypes

    from bella_tpu_torch.align import _build

    if not ts.at.is_cuda:
        raise ValueError("launch_streams takes CUDA tensors")
    B = ts.at.shape[0]
    dev = ts.at.device
    out = torch.empty((4 if with_steps else 3, B), dtype=torch.int32,
                      device=dev)
    if B == 0:
        return out
    lib = _build.xdrop_lib()
    order = longest_first(ts.len, qs.len)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)

    def ptr(t):
        return ctypes.c_void_p(t.data_ptr())

    # the library links its own CUDA runtime, which launches on the
    # calling thread's current device: make it the tensors' card
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.bella_xdrop_launch(
            ptr(ts.words), ts.words.numel(), ptr(ts.at),
            ptr(qs.words), qs.words.numel(), ptr(qs.at),
            ptr(ts.len), ptr(qs.len), ptr(order), ptr(counter),
            B, W, int(xdrop), int(cap), 1 if adaptive else 0,
            1 if long_key else 0, ptr(out[0]), ptr(out[1]), ptr(out[2]),
            ptr(out[3]) if with_steps else None, ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"x-drop kernel launch failed: CUDA error {rc}")
    name = "launch.xdrop_adaptive" if adaptive else "launch.xdrop_static"
    count(name)
    count("xdrop.extensions", B)
    if long_key:
        count(name + "_long_key")
    return out


def _shifted(a: torch.Tensor, s: torch.Tensor, lanes: torch.Tensor):
    """out[b, p] = a[b, p + s[b]], NINF outside the band."""
    W = a.shape[1]
    idx = lanes + s[:, None]
    got = torch.gather(a, 1, idx.clamp(0, W - 1))
    return torch.where((idx >= 0) & (idx < W), got, NINF)


def xdrop_plain(Tw, t_len, Qw, q_len, xdrop: int, W: int, cap: int,
                adaptive: bool, with_steps: bool = False) -> torch.Tensor:
    """Plain PyTorch version of csrc/xdrop.cu (both modes), on any device:
    one iteration per antidiagonal over (B, W) tensors. Same (3|4, B)
    int32 result as launch_streams."""
    dev = Tw.device
    B = Tw.shape[0]
    T, Q = unpack_words(Tw), unpack_words(Qw)
    Lt, Lq = max(T.shape[1], 1), max(Q.shape[1], 1)
    if T.shape[1] == 0:
        T = torch.zeros((B, 1), dtype=torch.uint8, device=dev)
    if Q.shape[1] == 0:
        Q = torch.zeros((B, 1), dtype=torch.uint8, device=dev)
    tl, ql = t_len.to(torch.int64), q_len.to(torch.int64)
    lanes = torch.arange(W, device=dev, dtype=torch.int64)[None, :]
    a1 = torch.full((B, W), NINF, dtype=torch.int64, device=dev)
    a1[:, 0] = 0
    a2 = torch.full((B, W), NINF, dtype=torch.int64, device=dev)
    a2[:, 0] = torch.where(ql >= 1, GAP, NINF)
    a2[:, 1] = torch.where(tl >= 1, GAP, NINF)
    zero = torch.zeros(B, dtype=torch.int64, device=dev)
    lo_m2, lo_m1, lo = zero, zero, zero
    best, best_t, best_q, steps = zero, zero, zero, zero
    alive = (tl + ql) > 0
    d, step = 2, 0
    while step < cap and bool(alive.any()):
        if not adaptive:
            lo = torch.full((B,), max(0, (d - W + 1) >> 1), dtype=torch.int64,
                            device=dev)
        i = lo[:, None] + lanes
        j = d - i
        valid = (i <= tl[:, None]) & (j >= 0) & (j <= ql[:, None])
        diag = _shifted(a1, lo - lo_m2 - 1, lanes)
        gq = _shifted(a2, lo - lo_m1 - 1, lanes)
        gt = _shifted(a2, lo - lo_m1, lanes)
        tc = torch.gather(T, 1, (i - 1).clamp(0, Lt - 1))
        qc = torch.gather(Q, 1, (j - 1).clamp(0, Lq - 1))
        sub = torch.where((i >= 1) & (j >= 1) & (tc == qc), MATCH, MISMATCH)
        a3 = torch.maximum(diag + sub, torch.maximum(gq, gt) + GAP)
        if adaptive:
            a3 = a3.clamp_min(NINF)
        a3 = torch.where(valid, a3, NINF)
        cur = a3.amax(dim=1)
        argp = a3.argmax(dim=1)  # first index of the max
        improved = alive & (cur > best)
        best = torch.where(improved, cur, best)
        best_t = torch.where(improved, lo + argp, best_t)
        best_q = torch.where(improved, d - (lo + argp), best_q)
        steps = steps + alive.to(torch.int64)
        alive = alive & (cur >= best - xdrop) & (d < tl + ql)
        lo_m2, lo_m1 = lo_m1, lo
        if adaptive:
            lo = torch.where(alive & (argp > W // 2), lo + 1, lo)
        a1, a2 = a2, a3
        d += 1
        step += 1
    rows = [best, best_t, best_q] + ([steps] if with_steps else [])
    return torch.stack(rows).to(torch.int32)


def run_xdrop(Tw, t_len, Qw, q_len, xdrop, W: int, cap: int,
              adaptive: bool, with_steps: bool = False) -> torch.Tensor:
    """The x-drop extension of Tw's row e against Qw's, for every e:
    run_streams on the rows' row_streams, once _check has read the longest
    length (from the card for CUDA tensors)."""
    longest = _check(Tw, t_len, Qw, q_len, int(xdrop), W)
    return run_streams(row_streams(Tw, t_len), row_streams(Qw, q_len),
                       xdrop, W, cap, adaptive, longest, with_steps)


def _check_streams(ts: Streams, qs: Streams, xdrop: int, W: int,
                   longest: int) -> None:
    """Raise on streams the kernel does not take; reads nothing back from
    the card."""
    B = ts.at.shape[0]
    for s in (ts, qs):
        if (s.words.dim() != 1 or s.words.dtype != torch.int32
                or not s.words.is_contiguous()):
            raise ValueError("stream words must be a contiguous 1-D int32 "
                             "tensor")
        if (s.at.shape != (B,) or s.at.dtype != torch.int64
                or not s.at.is_contiguous()):
            raise ValueError(f"descriptors must be a contiguous ({B},) "
                             "int64 tensor")
        if (s.len.shape != (B,) or s.len.dtype != torch.int32
                or not s.len.is_contiguous()):
            raise ValueError(f"lengths must be a contiguous ({B},) int32 "
                             "tensor")
    devs = {t.device for s in (ts, qs) for t in (s.words, s.at, s.len)}
    if len(devs) != 1:
        raise ValueError(f"inputs lie on several devices: {devs}")
    if not 2 <= W <= MAX_BAND:
        raise ValueError(f"band {W} outside [2, {MAX_BAND}]")
    if not 0 <= xdrop < MAX_EXTENT:
        raise ValueError(f"xdrop {xdrop} outside [0, {MAX_EXTENT})")
    if not 0 <= longest < MAX_EXTENT:
        raise ValueError(f"lengths must be below {MAX_EXTENT}")


def _where(mask: torch.Tensor) -> torch.Tensor:
    """The indexes where mask holds (a host wait on the card, counted as
    sync.align)."""
    if mask.is_cuda:
        count("sync.align")
    return torch.nonzero(mask).squeeze(1)


def run_streams(ts: Streams, qs: Streams, xdrop: int, W: int, cap: int,
                adaptive: bool, longest: int,
                with_steps: bool = False) -> torch.Tensor:
    """The x-drop extension of ts's stream e against qs's, for every e:
    the kernel for CUDA tensors, the plain version (the streams gathered
    into rows, then xdrop_plain) for CPU tensors, an error for anything
    else. longest bounds every stream's length from what the caller knows
    (no length is read back from the card). On the card it picks the key:
    the int32 key when longest and xdrop lie below INT32_KEY_EXTENT;
    otherwise the extensions at or above it run in a long-key launch of
    their own and the rest in an int32-key launch (one host wait for
    which are which), or all in the long-key one when xdrop needs it.
    Same (3|4, B) int32 result as launch_streams."""
    xdrop = int(xdrop)
    _check_streams(ts, qs, xdrop, W, int(longest))
    if ts.at.is_cuda:
        if not needs_long_key(longest, xdrop):
            return launch_streams(ts, qs, xdrop, W, cap, adaptive, with_steps)
        if needs_long_key(0, xdrop):
            return launch_streams(ts, qs, xdrop, W, cap, adaptive, with_steps,
                                  long_key=True)
        out = torch.empty((4 if with_steps else 3, ts.at.shape[0]),
                          dtype=torch.int32, device=ts.at.device)
        long = torch.maximum(ts.len, qs.len) >= INT32_KEY_EXTENT
        for long_key, idx in ((True, _where(long)), (False, _where(~long))):
            out[:, idx] = launch_streams(ts.take(idx), qs.take(idx), xdrop,
                                         W, cap, adaptive, with_steps,
                                         long_key)
        return out
    if ts.at.device.type == "cpu":
        count("xdrop.extensions", ts.at.shape[0])
        n = int(torch.maximum(ts.len, qs.len).max()) if len(ts.len) else 0
        L = max(16, -(-n // 16) * 16)
        return xdrop_plain(stream_rows(ts, L), ts.len, stream_rows(qs, L),
                           qs.len, xdrop, W, cap, adaptive, with_steps)
    raise ValueError(f"no x-drop kernel for device {ts.at.device}")


def _as_dict(out: torch.Tensor) -> dict:
    names = ("score", "t_end", "q_end", "steps")
    return {names[r]: out[r] for r in range(out.shape[0])}


def _packed_args(Tw, band: int, max_steps: int):
    if max_steps <= 0:
        max_steps = 2 * 16 * Tw.shape[1]
    return round_band(band), static_step_cap(max_steps)


def extend_batch_packed(Tw, t_len, Qw, q_len, xdrop: int, band: int = 256,
                        max_steps: int = 0, with_steps: bool = False) -> dict:
    """K1 on packed words: the contract of extend_batch_pallas_packed.

    Tw, Qw: (B, L/16) int32 words (16 bases each, least significant
    first); t_len, q_len: (B,) int32. The band rounds up to a multiple of
    128; max_steps <= 0 means 2 * L. Returns dict(score, t_end, q_end)
    of (B,) int32, plus `steps` (antidiagonals run) when with_steps."""
    W, cap = _packed_args(Tw, band, max_steps)
    return _as_dict(run_xdrop(Tw, t_len, Qw, q_len, xdrop, W, cap, False,
                              with_steps))


def extend_batch_packed_plain(Tw, t_len, Qw, q_len, xdrop: int,
                              band: int = 256, max_steps: int = 0,
                              with_steps: bool = False) -> dict:
    """The plain version of extend_batch_packed, on any device."""
    W, cap = _packed_args(Tw, band, max_steps)
    _check(Tw, t_len, Qw, q_len, int(xdrop), W)
    return _as_dict(xdrop_plain(Tw, t_len, Qw, q_len, int(xdrop), W, cap,
                                False, with_steps))


def extend_batch_chars(T, t_len, Q, q_len, xdrop: int, band: int = 256,
                       max_steps: int = 0) -> dict:
    """K1 on (B, L) base-code matrices: the contract of
    extend_batch_pallas. Packs the codes into words and launches the same
    kernel as extend_batch_packed (it is not a second kernel)."""
    return extend_batch_packed(
        pack_words(T), t_len, pack_words(Q), q_len, xdrop, band=band,
        max_steps=max_steps if max_steps > 0 else 2 * T.shape[1],
    )


def extend_batch_chars_plain(T, t_len, Q, q_len, xdrop: int, band: int = 256,
                             max_steps: int = 0) -> dict:
    """The plain version of extend_batch_chars, on any device."""
    return extend_batch_packed_plain(
        pack_words(T), t_len, pack_words(Q), q_len, xdrop, band=band,
        max_steps=max_steps if max_steps > 0 else 2 * T.shape[1],
    )
