"""On the card: at h13k's canonical seed (400) the port's pass over the
HiFi corpus holds its anchors (nnzA, the candidate rows emitted, the
chains run, the pairs and the rows written), and a traced run of
hifi-ecoli-30x.h13k there is correct and reads detection's metrics."""

import pytest

from benchmark import cells
from benchmark.gen.simulate import write_fastq
from benchmark.run import make_corpus

pytestmark = pytest.mark.card

CELL = "hifi-ecoli-30x.h13k"
# the port's pass at seed 400 on an NVIDIA H100 80GB HBM3 (PERF.md §4)
NNZ = 84_225_067
ROWS = 1_017_922_296
RANGES = 3
PAIRS = 300_584
WRITTEN = 300_584


def test_canonical_h13k_holds_its_anchors(card, tmp_path):
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.pipeline import run_files
    from bella_tpu_torch.utils import log

    cell = cells.load(CELL)
    corpus = make_corpus(cell.traffic, cell.traffic["canonical_seed"])
    fq = tmp_path / "reads.fastq"
    write_fastq(str(fq), corpus)
    log.reset()
    res = run_files(str(fq), BellaConfig(**cell.config["flags"]),
                    output=str(tmp_path / "rows.m4"), device=card)
    assert res.nnz == NNZ
    assert log.COUNTS["detect.rows"] == ROWS
    assert log.COUNTS["detect.ranges"] == RANGES
    assert res.pairs.num_pairs == PAIRS
    assert res.num_output == WRITTEN


def test_traced_canonical_h13k_reads_detection_metrics(card):
    from benchmark.run import run_cell

    cell = cells.load(CELL)
    r = run_cell(cell, cell.traffic["canonical_seed"], 1.0, True,
                 device=card)
    assert r["correct"], r["compared"]
    m = r["metrics"]
    assert m["detect.ranges_per_pass"]["value"] == RANGES
    assert m["detect.mrows_per_s"]["value"] > 0
    assert m["detect.idle_s_per_pass"]["value"] > 0
