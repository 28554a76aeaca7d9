"""The harness end to end on the CPU at a tiny size: a sound run is
correct, traced or not; with the timed path broken underneath (an
answer altered where it is produced, half of the pairs left out, a row
left out of the file) `correct` comes out false; the control fails the
check; and without a card the command exits nonzero and prints no
result."""

import subprocess
import sys

import pytest
import torch

from benchmark import cells, control
from benchmark.run import run_cell
from conftest import ROOT

torch.set_num_threads(1)


def run(root, name, trace=False):
    return run_cell(cells.load(name, root), 7, 0.01, trace, device="cpu",
                    workers=1)


@pytest.mark.parametrize("name,trace", [("clr-ecoli-30x.tiny", True),
                                        ("clr-ecoli-30x-adaptive.tiny", False)])
def test_sound_run_is_correct(tiny_root, name, trace):
    r = run(tiny_root, name, trace)
    assert r["correct"], r["compared"]
    assert r["attempted"] >= 1 and r["failed"] == 0
    assert list(r)[-1] == "compared"
    assert all(c["value"] == 0 for c in r["compared"].values())
    # no card: no device metric
    assert r["device"]["memory_peak_bytes"] is None
    assert "peak_device_gb" not in r["metrics"]
    if trace:
        assert "xdrop.roofline_pct" not in r["metrics"]
        assert r["metrics"]["align.s_per_pass"]["value"] > 0
        # the port's counters: the CPU launches no kernel and makes no
        # card work to idle between
        assert r["metrics"]["align.launches_per_pass"]["value"] == 0
        assert r["metrics"]["align.syncs_per_pass"]["value"] >= 0
        assert "align.extensions_per_launch" not in r["metrics"]
        assert "align.idle_s_per_pass" not in r["metrics"]
    else:
        assert set(r["metrics"]) == {"corpus_bases_per_s", "setup_s"}


def _alter_score(fn):
    def wrapped(*a, **kw):
        out = fn(*a, **kw)
        out.score[len(out.score) // 2] += 1
        return out
    return wrapped


def _drop_half(fn):
    def wrapped(*a, **kw):
        pairs, nk, nnz = fn(*a, **kw)
        import dataclasses

        keep = slice(0, pairs.num_pairs // 2)
        return type(pairs)(**{f.name: getattr(pairs, f.name)[keep]
                              for f in dataclasses.fields(pairs)}), nk, nnz
    return wrapped


def _drop_row(fn):
    def wrapped(path, reads, *cols, **kw):
        cols = [c[1:] for c in cols]
        return fn(path, reads, *cols, **kw)
    return wrapped


@pytest.mark.parametrize("where,attr,fault", [
    ("bella_tpu_torch.pipeline", "align_candidates", _alter_score),
    ("bella_tpu_torch.pipeline", "detect_overlaps", _drop_half),
    ("bella_tpu_torch.io.writers", "write_m4_native", _drop_row),
])
def test_broken_path_is_not_correct(tiny_root, monkeypatch, where, attr,
                                    fault):
    import importlib

    mod = importlib.import_module(where)
    monkeypatch.setattr(mod, attr, fault(getattr(mod, attr)))
    r = run(tiny_root, "clr-ecoli-30x.tiny")
    assert not r["correct"]
    assert any(c["value"] > c["limit"] for c in r["compared"].values())


def test_control_fails_the_check(tiny_root):
    cell = cells.load("clr-ecoli-30x.tiny", tiny_root)
    got = control.readings(cell, 7, torch.device("cpu"), 1)
    assert got["detect_pairs_differing"] > 0
    assert got["correct"] is False


def test_no_card_exits_nonzero_without_a_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    r = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "clr-ecoli-30x.d6k", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert r.stdout == ""
