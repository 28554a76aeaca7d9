"""Find a cell of the benchmark by its name: its entry in BENCHMARK.json,
its configuration file, its traffic mix and the readers of its metrics.

Everything that belongs to one configuration, one traffic mix or one
metric is a file of its own, found by the name BENCHMARK.json gives it:

  * the configuration: the `file` of its entry in `configs` (JSON: the
    port's flags as run, the source, `assumed`, `reduced`);
  * the traffic mix: benchmark/traffic/<traffic>.json (the corpus
    recipe: genome and read parameters, seed offsets, check sample),
    and the file of read lengths it may name beside it;
  * each metric: benchmark/metrics/<metric name>.py, whose read(record)
    returns the metric's value from a run's record, or None where the
    record holds nothing to read. The record (benchmark/run.py) holds
    `passes`, `window_s`, `setup_s`, `corpus_bases`, `peak_bytes`,
    `kind`, the port's phase seconds `phase_s` and counters `counts`
    (a counter absent there counted nothing), and, traced, `trace`:
    `busy_s`, `window_s`, `align_kernel_s`, `idle_in_span`,
    `idle_by_innermost`, `span_s` (each bella.* span's host seconds) and
    the rest that tracing.summarise gives. A metric whose entry lists
    `workloads` is read in those cells alone.

So a cell, a mix or a metric is added by adding files and entries.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


@dataclasses.dataclass
class Metric:
    name: str
    unit: str
    read: Callable[[dict], object]


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[Metric]
    per_layer: List[Metric]

    def metrics(self, trace: bool) -> List[Metric]:
        return self.per_layer if trace else self.end_to_end


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def traffic(name: str, root: Path = ROOT) -> dict:
    """The traffic mix `name`; where its reads name a `lengths_file`
    (one length a line, beside the mix), `lengths` holds those lengths."""
    here = Path(root) / "benchmark" / "traffic"
    mix = _json(here / f"{name}.json")
    reads = mix["reads"]
    if "lengths_file" in reads:
        with open(here / reads["lengths_file"]) as f:
            lengths = [int(x) for x in f.read().split()]
        mix["reads"] = dict(reads, lengths=lengths)
    return mix


def phase_s_per_pass(record: dict, phases) -> object:
    """Seconds a pass of the window spends in the port's `phases`
    (utils/log.py's PHASE_SECONDS, host clock), whichever the path runs,
    summed over the passes, over the passes; None where it ran none."""
    got = [record["phase_s"][p] for p in phases if p in record["phase_s"]]
    if not record["passes"] or not got:
        return None
    return sum(got) / record["passes"]


def counted(record: dict, names) -> object:
    """The sum of the port's counters `names` over the window (utils/log.py's
    COUNTS; one the run never counted reads 0); None where the record
    holds no counters (a port without them)."""
    counts = record.get("counts")
    if counts is None:
        return None
    return sum(counts.get(n, 0) for n in names)


def count_per_pass(record: dict, names) -> object:
    """`counted` over the window's passes; None where it ran none."""
    n = counted(record, names)
    if n is None or not record["passes"]:
        return None
    return n / record["passes"]


def _reader(root: Path, name: str) -> Callable[[dict], object]:
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader for metric {name}: {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load(name: str, root: Path = ROOT) -> Cell:
    """The cell `name` of root/BENCHMARK.json. Raises KeyError for a cell
    the file does not list."""
    root = Path(root)
    spec = _json(root / "BENCHMARK.json")
    cells: Dict[str, dict] = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in {root / 'BENCHMARK.json'}"
                       f" (known: {sorted(cells)})")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    config = _json(root / configs[w["config"]]["file"])

    def metrics(key: str) -> List[Metric]:
        return [Metric(m["name"], m["unit"], _reader(root, m["name"]))
                for m in spec[key] if _applies(m, name)]

    return Cell(name, int(w["chips"]), config, traffic(w["traffic"], root),
                metrics("end_to_end"), metrics("per_layer"))
