"""Seconds a pass of the window spends in the decision and the rows: the
port's decision and outputting phases (host clock; the rows file is
written when the phase ends), over the passes."""

from benchmark.cells import phase_s_per_pass

PHASES = ("decision", "outputting")


def read(record):
    return phase_s_per_pass(record, PHASES)
