"""Seconds a pass of the window spends in FASTQ ingest: the port's
fastqParsing phase (host clock), summed over the passes, over the
passes."""

from benchmark.cells import phase_s_per_pass

PHASES = ("fastqParsing",)


def read(record):
    return phase_s_per_pass(record, PHASES)
