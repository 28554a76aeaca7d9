"""BENCHMARK.json against the harness: every metric has its reader, every
configuration and traffic mix its file, and a cell, a mix and a metric
added as new files are found without an edit."""

import json
import re

import pytest

from benchmark import cells
from conftest import ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def expected(s, key, cell):
    """The metrics of s[key] that cell reports: those without a
    `workloads` list, and those whose list names the cell."""
    return {m["name"] for m in s[key]
            if "workloads" not in m or cell in m["workloads"]}


def check_every_cell(root):
    """Every cell of root/BENCHMARK.json loads with the metrics its
    entries give it, each with its reader; every name is well formed and
    unique, and every `workloads` list names cells of the file."""
    s = json.loads((root / "BENCHMARK.json").read_text())
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    names = {w["name"] for w in s["workloads"]}
    for m in s["end_to_end"] + s["per_layer"]:
        assert set(m.get("workloads", names)) <= names, m["name"]
    for w in s["workloads"]:
        cell = cells.load(w["name"], root)
        assert cell.chips == w["chips"] and cell.chips in (1, 4)
        e2e = {m.name for m in cell.end_to_end}
        assert e2e == expected(s, "end_to_end", w["name"])
        assert "setup_s" in e2e and len(e2e) >= 2
        per_layer = [m.name for m in cell.per_layer]
        assert len(per_layer) == len(set(per_layer))
        assert set(per_layer) == expected(s, "per_layer", w["name"])
        assert per_layer
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


def test_every_cell_loads_with_its_metrics():
    check_every_cell(ROOT)


def test_metric_added_with_its_cells_passes_the_layout(tiny_root):
    """A later change adds a reader file and its entry, with a
    `workloads` list: every cell still loads, each with its metrics."""
    (tiny_root / "benchmark/metrics/align.passes_seen.py").write_text(
        "def read(record):\n    return record['passes']\n")
    s = json.loads((tiny_root / "BENCHMARK.json").read_text())
    s["per_layer"].append({"name": "align.passes_seen", "unit": "passes",
                           "better": "higher", "source": "program_counter",
                           "layer": "alignment driver",
                           "moves": "corpus_bases_per_s",
                           "workloads": ["clr-ecoli-30x.tiny"]})
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(s))
    check_every_cell(tiny_root)
    got = {m.name for m in cells.load("clr-ecoli-30x.tiny",
                                      tiny_root).per_layer}
    assert "align.passes_seen" in got
    assert "align.passes_seen" not in {
        m.name for m in cells.load("clr-ecoli-30x.d6k", tiny_root).per_layer}
    # a list that names no cell of the file fails the layout
    s["per_layer"][-1]["workloads"] = ["no-such-cell"]
    (tiny_root / "BENCHMARK.json").write_text(json.dumps(s))
    with pytest.raises(AssertionError):
        check_every_cell(tiny_root)


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
