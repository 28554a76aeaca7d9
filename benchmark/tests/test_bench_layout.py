"""BENCHMARK.json against the harness: every metric has its reader, every
configuration and traffic mix its file, and a cell, a mix and a metric
added as new files are found without an edit."""

import json
import re

import pytest

from benchmark import cells
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def spec():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def test_every_cell_loads_with_its_metrics():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    for w in s["workloads"]:
        cell = cells.load(w["name"])
        assert cell.chips == 1
        assert {m.name for m in cell.end_to_end} == {
            "corpus_bases_per_s", "peak_device_gb", "setup_s"}
        assert len(cell.per_layer) == 6
        assert set(cell.config["flags"]) >= {
            "kmer_size", "xdrop", "error_rate", "bin_size", "lower_freq",
            "upper_freq", "delta_chernoff", "aligner_backend",
            "pallas_band", "band_width", "band_rescue", "rescue_predict",
            "rescue_ceiling"}
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in s[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert len({c["source"] for c in s["configs"]}) == len(s["configs"])


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        cells.load("no-such-config.d6k")


def test_cell_added_as_new_files_is_found(tiny_root):
    """A later change adds a configuration file, a traffic file, a metric
    reader and their entries: the harness finds them by name."""
    cfg = json.loads((ROOT / "benchmark/configs/clr-ecoli-30x.json")
                     .read_text())
    cfg["name"] = "clr-ecoli-30x-b256"
    cfg["flags"]["pallas_band"] = 256
    (tiny_root / "benchmark/configs/clr-ecoli-30x-b256.json").write_text(
        json.dumps(cfg))
    (tiny_root / "benchmark/metrics/passes.py").write_text(
        "def read(record):\n    return record['passes']\n")
    s = json.loads((tiny_root / "BENCHMARK.json").read_text())
    s["configs"].append({"name": "clr-ecoli-30x-b256", "source": "x",
                         "file": "benchmark/configs/clr-ecoli-30x-b256.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "clr-ecoli-30x-b256.tiny",
                           "config": "clr-ecoli-30x-b256",
                           "traffic": "tiny", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "passes", "unit": "passes",
                           "better": "higher", "source": "host_clock",
                           "layer": "device", "moves": "corpus_bases_per_s",
                           "workloads": ["clr-ecoli-30x-b256.tiny"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(s))
    cell = cells.load("clr-ecoli-30x-b256.tiny", tiny_root)
    assert cell.config["flags"]["pallas_band"] == 256
    assert cell.traffic["reads"]["count"] == 16
    got = {m.name: m for m in cell.per_layer}
    assert got["passes"].read({"passes": 3}) == 3
    # the metric is the new cell's alone
    other = cells.load("clr-ecoli-30x.tiny", tiny_root)
    assert "passes" not in {m.name for m in other.per_layer}
