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

A wrapper launches the kernel for CUDA tensors and raises if it cannot;
it takes the plain PyTorch version (``xdrop_plain``, a loop over
antidiagonals on (B, W) tensors) only for tensors on the CPU.
"""

from __future__ import annotations

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


def launch_xdrop(Tw, t_len, Qw, q_len, xdrop: int, W: int, cap: int,
                 adaptive: bool, with_steps: bool = False,
                 long_key: bool = False) -> torch.Tensor:
    """Launch csrc/xdrop.cu on CUDA tensors. Returns a (3, B) int32 tensor
    (score, t_end, q_end), with a fourth row of antidiagonal counts when
    with_steps. long_key selects the long-key instantiation (run_xdrop
    sets it from the batch, needs_long_key). Raises if the library cannot
    be built or the launch fails; never falls back to the plain version.
    The kernel takes extensions in longest_first order from a counter
    zeroed here, and writes each result at its extension's index."""
    import ctypes

    from bella_tpu_torch.align import _build

    if not Tw.is_cuda:
        raise ValueError("launch_xdrop takes CUDA tensors")
    B = Tw.shape[0]
    out = torch.empty((4 if with_steps else 3, B), dtype=torch.int32,
                      device=Tw.device)
    if B == 0:
        return out
    lib = _build.xdrop_lib()
    order = longest_first(t_len, q_len)
    counter = torch.zeros(1, dtype=torch.int32, device=Tw.device)
    # the library links its own CUDA runtime, which launches on the
    # calling thread's current device: make it the tensors' card
    with torch.cuda.device(Tw.device):
        stream = torch.cuda.current_stream(Tw.device).cuda_stream
        rc = lib.bella_xdrop_launch(
            ctypes.c_void_p(Tw.data_ptr()), ctypes.c_void_p(Qw.data_ptr()),
            Tw.stride(0), Qw.stride(0),
            ctypes.c_void_p(t_len.data_ptr()), ctypes.c_void_p(q_len.data_ptr()),
            ctypes.c_void_p(order.data_ptr()),
            ctypes.c_void_p(counter.data_ptr()),
            B, W, int(xdrop), int(cap), 1 if adaptive else 0,
            1 if long_key else 0,
            ctypes.c_void_p(out[0].data_ptr()), ctypes.c_void_p(out[1].data_ptr()),
            ctypes.c_void_p(out[2].data_ptr()),
            ctypes.c_void_p(out[3].data_ptr()) if with_steps else None,
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise RuntimeError(f"x-drop kernel launch failed: CUDA error {rc}")
    name = "launch.xdrop_adaptive" if adaptive else "launch.xdrop_static"
    count(name)
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
    int32 result as launch_xdrop."""
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
    """Dispatch on the tensors' device: the kernel for CUDA tensors (the
    int32-key or the long-key instantiation, from the batch's lengths and
    xdrop), the plain version for CPU tensors, an error for anything
    else."""
    longest = _check(Tw, t_len, Qw, q_len, int(xdrop), W)
    if Tw.is_cuda:
        return launch_xdrop(Tw, t_len, Qw, q_len, int(xdrop), W, cap,
                            adaptive, with_steps,
                            long_key=needs_long_key(longest, xdrop))
    if Tw.device.type == "cpu":
        return xdrop_plain(Tw, t_len, Qw, q_len, int(xdrop), W, cap, adaptive,
                           with_steps)
    raise ValueError(f"no x-drop kernel for device {Tw.device}")


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
