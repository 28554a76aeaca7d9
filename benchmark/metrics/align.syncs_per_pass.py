"""Blocking host reads of card tensors in the aligner a pass of the
window: the port's `sync.align` counter (uploads from pageable memory,
downloads, a level's long-key split, the word-row entries' checks), over
the passes."""

from benchmark.cells import count_per_pass

COUNTERS = ("sync.align",)


def read(record):
    return count_per_pass(record, COUNTERS)
