"""Seconds a pass of the window spends in detection: the port's
overlapDetection, kmerCounting and coverageEstimation phases, whichever
the path runs (host clock; each ends on host arrays), over the passes."""

from benchmark.cells import phase_s_per_pass

PHASES = ("overlapDetection", "kmerCounting", "coverageEstimation")


def read(record):
    return phase_s_per_pass(record, PHASES)
