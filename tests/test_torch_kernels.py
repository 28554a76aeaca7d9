"""The port's x-drop kernels against bella_tpu, on the CPU.

On CPU tensors the port's wrappers run their kernels' plain versions, so
these tests hold K1's plain version (bella_tpu_torch.align.pallas_xdrop)
bit-exact against the Pallas kernel in interpret mode, through both of its
entries, and K2's plain version (bella_tpu_torch.align.xdrop.extend_batch)
bit-exact against bella_tpu.align.xdrop.extend_batch. Every comparison is
exact: all outputs are integers. Above 2^17 bases, where the kernels take
their long-key instantiation, both plain versions are held against
bella_tpu.align.xdrop.extend_batch on one near-identical pair.

The interpret-mode Pallas calls run in fresh subprocesses, as
tests/test_pallas_align.py runs its wide-band cases (XLA's CPU backend
can segfault compiling them late in a many-compile worker), and so do
the long plain runs; all four start with the module's first test.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from bella_tpu.align.xdrop import extend_batch as jax_extend_batch
from bella_tpu.align.xdrop import pack_words as jax_pack_words
from bella_tpu_torch.align import pallas_xdrop as P
from bella_tpu_torch.align import xdrop as X
from torch_test_support import subprocess_env

XDROP = 20
BANDS = (128, 256)


def k1_inputs():
    """A mixed batch: empty rows, one-sided rows, 15 % error rows and rows
    whose optimal path drifts one lane every 3 bases (149 lanes: out of
    the static W = 128 band, whose lanes reach 127 off the diagonal),
    lengths up to L."""
    rng = np.random.default_rng(2024)
    B, L = 12, 448
    T = np.full((B, L), 127, np.int8)
    Q = np.full((B, L), 127, np.int8)
    tl = np.zeros(B, np.int32)
    ql = np.zeros(B, np.int32)
    for b in range(B):
        n = L if b % 3 == 0 else int(rng.integers(1, L + 1))
        t = rng.integers(0, 4, n).astype(np.int8)
        if b % 3 == 0:
            q = t[np.arange(n) % 3 != 2]
        else:
            r = rng.random(n)
            q = t.copy()
            q[r < 0.05] = (q[r < 0.05] + 1) % 4
            q = q[~((r >= 0.05) & (r < 0.10))]
        T[b, :n] = t
        Q[b, :len(q)] = q
        tl[b], ql[b] = n, len(q)
    tl[0] = ql[0] = 0   # empty pair
    ql[1] = 0           # one side empty
    return T, tl, Q, ql


def _jax_k1_main(out_path, entry):
    """Subprocess body: the Pallas kernel (interpret mode) at each band
    through one entry; results to an npz."""
    import jax

    jax.config.update("jax_platforms", "cpu")
    from bella_tpu.align.pallas_xdrop import (
        extend_batch_pallas, extend_batch_pallas_packed,
    )

    T, tl, Q, ql = k1_inputs()
    L = T.shape[1]
    res = {}
    for band in BANDS:
        if entry == "packed":
            out = extend_batch_pallas_packed(
                jnp.asarray(jax_pack_words(T)), jnp.asarray(tl),
                jnp.asarray(jax_pack_words(Q)), jnp.asarray(ql), XDROP,
                band=band, max_steps=2 * L, interpret=True,
            )
        else:
            out = extend_batch_pallas(
                jnp.asarray(T), jnp.asarray(tl), jnp.asarray(Q),
                jnp.asarray(ql), XDROP, band=band, max_steps=2 * L,
                interpret=True,
            )
        for k, v in out.items():
            res[f"{band}_{k}"] = np.asarray(v)
    np.savez(out_path, **res)


@pytest.fixture(scope="module", autouse=True)
def subprocs(tmp_path_factory):
    """The module's four subprocesses, started together with its first
    test: the interpret-mode Pallas kernel through each entry, and each
    plain version on the long pair (a minute or more each), so that the
    long ones run beside the tests before theirs. Yields {name: (npz
    path, Popen)}; kills what is left at the end."""
    d = tmp_path_factory.mktemp("subprocs")
    env = subprocess_env()
    procs = {}
    for name, main in (("packed", "_jax_k1_main"), ("chars", "_jax_k1_main"),
                       ("K1", "_long_plain_main"), ("K2", "_long_plain_main")):
        path = str(d / f"{name}.npz")
        code = (f"from test_torch_kernels import {main}; "
                f"{main}({path!r}, {name!r})")
        procs[name] = (path, subprocess.Popen(
            [sys.executable, "-c", code], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        ))
    yield procs
    for _, p in procs.values():
        if p.poll() is None:
            p.kill()
        p.communicate()


def _wait(procs, names, timeout) -> dict:
    out = {}
    for name in names:
        path, p = procs[name]
        _, err = p.communicate(timeout=timeout)
        assert p.returncode == 0, err[-3000:]
        out[name] = dict(np.load(path))
    return out


@pytest.fixture(scope="module")
def pallas_results(subprocs):
    return _wait(subprocs, ("packed", "chars"), 400)


def _torch_inputs():
    return [torch.from_numpy(a) for a in k1_inputs()]


@pytest.mark.parametrize("band", BANDS)
def test_k1_plain_matches_pallas_packed(pallas_results, band):
    T, tl, Q, ql = k1_inputs()
    L = T.shape[1]
    Tw = torch.from_numpy(jax_pack_words(T).view(np.int32))
    Qw = torch.from_numpy(jax_pack_words(Q).view(np.int32))
    got = P.extend_batch_packed(Tw, torch.from_numpy(tl), Qw,
                                torch.from_numpy(ql), XDROP, band=band,
                                max_steps=2 * L)
    ref = pallas_results["packed"]
    for k in ("score", "t_end", "q_end"):
        np.testing.assert_array_equal(got[k].numpy(), ref[f"{band}_{k}"],
                                      err_msg=k)


@pytest.mark.parametrize("band", BANDS)
def test_k1_plain_matches_pallas_chars(pallas_results, band):
    T, tl, Q, ql = _torch_inputs()
    got = P.extend_batch_chars(T, tl, Q, ql, XDROP, band=band,
                               max_steps=2 * T.shape[1])
    ref = pallas_results["chars"]
    for k in ("score", "t_end", "q_end"):
        np.testing.assert_array_equal(got[k].numpy(), ref[f"{band}_{k}"],
                                      err_msg=k)
    # the batch exercises the band edge: a drift row scores below its
    # adaptive-band extension at W = 128
    if band == 128:
        k2 = X.extend_batch(T, tl, Q, ql, XDROP, band=128)
        assert (k2["score"] > got["score"]).any()


@pytest.mark.parametrize("xdrop,band", [(7, 128), (50, 128), (20, 64)])
def test_k2_plain_matches_extend_batch(xdrop, band):
    T, tl, Q, ql = k1_inputs()
    L = T.shape[1]
    ref = jax_extend_batch(jnp.asarray(T), jnp.asarray(tl), jnp.asarray(Q),
                           jnp.asarray(ql), xdrop, band=band, max_steps=2 * L)
    got = X.extend_batch(*(torch.from_numpy(a) for a in (T, tl, Q, ql)),
                         xdrop, band=band, max_steps=2 * L)
    for k in ("score", "t_end", "q_end"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)


@pytest.mark.parametrize("band,max_steps", [
    (33, 0), (100, 0),            # bands no multiple of 32: masked lanes
    (100, 150), (128, 301), (33, 97),  # step caps below t_len + q_len
    (31, 0), (31, 150),           # the reference's band, below one tile
])
def test_k2_plain_matches_extend_batch_edges(band, max_steps):
    """The semantics K2's tiling and step cap must keep: lanes past a band
    that is no multiple of the warp's tile, and a cap that binds."""
    T, tl, Q, ql = k1_inputs()
    steps = max_steps or 2 * T.shape[1]
    if max_steps:
        assert max_steps < int((tl + ql).max())
    ref = jax_extend_batch(jnp.asarray(T), jnp.asarray(tl), jnp.asarray(Q),
                           jnp.asarray(ql), XDROP, band=band,
                           max_steps=steps)
    got = X.extend_batch(*(torch.from_numpy(a) for a in (T, tl, Q, ql)),
                         XDROP, band=band, max_steps=steps)
    for k in ("score", "t_end", "q_end"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    if max_steps:  # the cap changes a result: it binds
        full = X.extend_batch(*(torch.from_numpy(a) for a in (T, tl, Q, ql)),
                              XDROP, band=band, max_steps=2 * T.shape[1])
        assert (full["score"] != got["score"]).any()


@pytest.mark.parametrize("adaptive", [False, True])
def test_longest_first_order_scatters_back(adaptive):
    """The kernel takes extensions longest first and writes each result at
    its own index: running the batch in that order and scattering back
    gives the input-order result."""
    T, tl, Q, ql = _torch_inputs()
    Tw, Qw = P.pack_words(T), P.pack_words(Q)
    order = P.longest_first(tl, ql)
    assert order.dtype == torch.int32
    o = order.long()
    total = (tl + ql)[o]
    assert bool((total[:-1] >= total[1:]).all())
    ties = total[:-1] == total[1:]
    assert bool((o[:-1][ties] < o[1:][ties]).all())  # stable
    cap = 2 * T.shape[1]
    ref = P.xdrop_plain(Tw, tl, Qw, ql, XDROP, 128, cap, adaptive, True)
    run = P.xdrop_plain(Tw[o], tl[o].contiguous(), Qw[o], ql[o].contiguous(),
                        XDROP, 128, cap, adaptive, True)
    back = torch.empty_like(run)
    back[:, o] = run
    assert torch.equal(back, ref)


def test_pack_words_matches_reference():
    rng = np.random.default_rng(3)
    mat = rng.integers(0, 4, (5, 77)).astype(np.int8)
    mat[1, 40:] = 127  # padding collapses to 'A'
    ref = jax_pack_words(np.pad(mat, ((0, 0), (0, 3)), constant_values=0))
    got = P.pack_words(torch.from_numpy(mat))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), ref)
    back = P.unpack_words(got)[:, :77].numpy()
    np.testing.assert_array_equal(back, mat.astype(np.uint8) & 3)


def test_wrappers_check_inputs():
    T, tl, Q, ql = _torch_inputs()
    Tw, Qw = P.pack_words(T), P.pack_words(Q)
    with pytest.raises(ValueError):  # lengths past the word rows
        P.extend_batch_packed(Tw[:, :2], tl, Qw, ql, XDROP)
    with pytest.raises(ValueError):  # int64 lengths
        P.extend_batch_packed(Tw, tl.long(), Qw, ql, XDROP)
    with pytest.raises(ValueError):  # the kernel launcher takes CUDA tensors
        P.launch_streams(P.row_streams(Tw, tl), P.row_streams(Qw, ql), XDROP,
                         128, 1024, False)


LONG = (1 << 17) + 100  # bases on each side of the long extension


def _long_pair():
    """One extension of LONG bases a side, Q = T with 3 % substitutions
    and no indels."""
    rng = np.random.default_rng(17)
    t = rng.integers(0, 4, LONG).astype(np.int8)
    q = t.copy()
    sub = rng.random(LONG) < 0.03
    q[sub] = (q[sub] + 1) % 4
    n = np.array([LONG], np.int32)
    return t[None], n, q[None], n.copy()


def _long_plain_main(out_path, kernel):
    """Subprocess body: K1's or K2's plain version on the long pair."""
    args = [torch.from_numpy(a) for a in _long_pair()]
    if kernel == "K1":
        got = P.extend_batch_chars(*args, XDROP, band=128, max_steps=2 * LONG)
    else:
        got = X.extend_batch(*args, XDROP, band=128, max_steps=2 * LONG)
    np.savez(out_path, **{k: v.numpy() for k, v in got.items()})


@pytest.fixture(scope="module")
def long_results(subprocs):
    """Both plain versions on the long pair, from their subprocesses, and
    bella_tpu's extend_batch on it here meanwhile."""
    T, tl, Q, ql = _long_pair()
    ref = jax_extend_batch(jnp.asarray(T), jnp.asarray(tl), jnp.asarray(Q),
                           jnp.asarray(ql), XDROP, band=128,
                           max_steps=2 * LONG)
    out = {"ref": {k: np.asarray(v) for k, v in ref.items()}}
    out.update(_wait(subprocs, ("K1", "K2"), 600))
    return out


@pytest.mark.parametrize("kernel", ["K1", "K2"])
def test_plain_long_extension_matches_extend_batch(long_results, kernel):
    """Both plain versions above 2^17 bases. The path stays on the
    diagonal, where the static band and the adaptive band give one
    answer, so K1's plain version is held against bella_tpu's
    extend_batch too: the interpret-mode Pallas kernel would take many
    minutes at this length."""
    ref, got = long_results["ref"], long_results[kernel]
    assert int(ref["t_end"][0]) == LONG and int(ref["score"][0]) > 1 << 16
    for k in ("score", "t_end", "q_end"):
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)


def test_long_key_choice():
    """The int32-key instantiation below 2^17 (lengths and xdrop), the
    long-key one from there up to MAX_EXTENT, where the wrappers stop."""
    assert not P.needs_long_key(P.INT32_KEY_EXTENT - 1, XDROP)
    assert P.needs_long_key(P.INT32_KEY_EXTENT, XDROP)
    assert P.needs_long_key(100, P.INT32_KEY_EXTENT)
    T = torch.zeros((1, 1), dtype=torch.int32)
    n = torch.tensor([P.MAX_EXTENT], dtype=torch.int32)
    with pytest.raises(ValueError, match="below"):
        P._check(T.expand(1, P.MAX_EXTENT // 16).contiguous(), n, T,
                 torch.zeros(1, dtype=torch.int32), XDROP, 128)
