"""On the card: at d6k's canonical seed the port's pass holds dataset D's
anchors (bench_torch.py): nnzA 13,996,132, 1,434,878 pairs, and 619,273
rows on the static aligner, 619,271 on the adaptive one; and a traced
run of each cell there reads the launches and syncs a pass that the
port's counters give."""

import pytest

from benchmark import cells
from benchmark.gen.simulate import write_fastq
from benchmark.run import make_corpus

pytestmark = pytest.mark.card


@pytest.mark.parametrize("config,rows", [("clr-ecoli-30x", 619_273),
                                         ("clr-ecoli-30x-adaptive", 619_271)])
def test_canonical_d6k_holds_dataset_d_anchors(card, tmp_path, config, rows):
    from bella_tpu_torch.config import BellaConfig
    from bella_tpu_torch.pipeline import run_files

    cell = cells.load(f"{config}.d6k")
    corpus = make_corpus(cell.traffic, cell.traffic["canonical_seed"])
    fq = tmp_path / "reads.fastq"
    write_fastq(str(fq), corpus)
    res = run_files(str(fq), BellaConfig(**cell.config["flags"]),
                    output=str(tmp_path / "rows.m4"), device=card)
    assert res.nnz == 13_996_132
    assert res.pairs.num_pairs == 1_434_878
    assert res.num_output == rows


@pytest.mark.parametrize("name,launches,syncs", [
    ("clr-ecoli-30x.d6k", 6, 15), ("clr-ecoli-30x-adaptive.d6k", 1, 5)])
def test_traced_canonical_d6k_counts_its_launches_and_syncs(card, name,
                                                            launches, syncs):
    """A traced run at the canonical seed: K1 at band 128 in one launch,
    one a cascade level and one for the tail (static), or K2 alone
    (adaptive), each pass; the syncs are the reads' uploads and each
    launch's pair block and download."""
    from benchmark.run import run_cell

    cell = cells.load(name)
    r = run_cell(cell, cell.traffic["canonical_seed"], 1.0, True,
                 device=card)
    assert r["correct"], r["compared"]
    m = r["metrics"]
    assert m["align.launches_per_pass"]["value"] == launches
    assert m["align.syncs_per_pass"]["value"] == syncs
    assert m["align.extensions_per_launch"]["value"] > 0
    assert m["align.idle_s_per_pass"]["value"] > 0
