"""Seconds a pass of the window spends in the alignment driver: the
port's alignment phase (host clock; it ends on host arrays), over the
passes."""

from benchmark.cells import phase_s_per_pass

PHASES = ("alignment",)


def read(record):
    return phase_s_per_pass(record, PHASES)
