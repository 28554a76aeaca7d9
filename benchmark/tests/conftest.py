"""The benchmark's own tests: `python -m pytest benchmark/tests` here (the
card's tests skip), `python -m pytest benchmark/tests -m card` on the
card. The repository's `pytest tests/` does not collect them.

A test that needs the card takes the `card` fixture, which decides inside
the test whether one is present, never at import."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a corpus the plain kernels on the CPU run in seconds
TINY = {
    "name": "tiny",
    "recipe": "a 12 kbp genome, 16 reads of mean 1.5 kbp at 15 % error",
    "genome": {"length": 12000, "seed_offset": 1},
    "reads": {"count": 16, "mean_len": 1500, "min_len": 500,
              "error_rate": 0.15, "circular": False, "seed_offset": 2},
    "canonical_seed": 0,
    "check": {"sample_reads": 16, "sample_pairs": 48,
              "sample_pairs_per_level": 4},
}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs a CUDA card (skips without one)")


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture
def tiny_root(tmp_path):
    """A copy of the benchmark with the `tiny` traffic mix added as a
    file of its own and one cell of it for each configuration, as a later
    change would add them."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    (tmp_path / "benchmark" / "traffic" / "tiny.json").write_text(
        json.dumps(TINY))
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    for c in spec["configs"]:
        spec["workloads"].append(
            {"name": f"{c['name']}.tiny", "config": c["name"],
             "traffic": "tiny", "chips": 1, "why": "CPU test"})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    return tmp_path
