"""On the card: at d6k's canonical seed the port's pass holds dataset D's
anchors (bench_torch.py): nnzA 13,996,132, 1,434,878 pairs, and 619,273
rows on the static aligner, 619,271 on the adaptive one."""

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
