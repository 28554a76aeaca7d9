"""The frozen generator: at d6k's canonical seed the corpus is dataset D
of bench_torch.py, every seed of d6k reads the same lengths, and the
FASTQ is the port's writer's, byte for byte."""

import numpy as np

from benchmark import cells

from benchmark.gen.simulate import (fastq_bytes, random_genome,
                                    sample_reads)
from benchmark.run import make_corpus
from conftest import ROOT


def mix(name):
    return cells.traffic(name, ROOT)


def test_d6k_at_its_canonical_seed_is_dataset_d():
    t = mix("d6k")
    c = make_corpus(t, t["canonical_seed"])
    assert c.num_reads == 23_000
    assert c.bases == 137_619_214


def test_every_d6k_seed_reads_the_same_lengths():
    t = mix("d6k")
    lens = t["reads"]["lengths"]
    assert len(lens) == 23_000 and sum(lens) == 137_618_755
    # without errors a read is its listed length, whatever the seed
    small = dict(t, genome=dict(t["genome"], length=100_000),
                 reads=dict(t["reads"], count=40, error_rate=0.0))
    a, b = (make_corpus(small, s) for s in (5, 2**31 + 77))
    assert a.lengths.tolist() == b.lengths.tolist() == lens[:40]
    assert not np.array_equal(a.codes, b.codes)


def test_large_seeds_are_accepted():
    t = dict(mix("d6k"), genome={"length": 5000, "seed_offset": 1},
             reads=dict(mix("d6k")["reads"], count=3, mean_len=1000,
                        min_len=500, lengths=None))
    a = make_corpus(t, 2**31 + 12345)
    b = make_corpus(t, 2**31 + 12345)
    assert np.array_equal(a.codes, b.codes)


def test_same_reads_and_fastq_as_the_port(tmp_path):
    from bella_tpu_torch.io import simulate as port

    rs, _ = port.sample_reads(port.random_genome(20000, seed=3), 30, 1500,
                              500, 0.15, seed=4, circular=False)
    port.write_fastq(str(tmp_path / "p.fq"), rs)
    c = sample_reads(random_genome(20000, seed=3), 30, 1500, 500, 0.15,
                     seed=4, circular=False)
    assert np.array_equal(c.codes, rs.codes)
    assert c.names == rs.names
    assert fastq_bytes(c) == (tmp_path / "p.fq").read_bytes()
