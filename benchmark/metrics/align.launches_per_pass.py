"""Kernel launches of the aligner a pass of the window: the port's
counters of K1 (static x-drop), K2 (adaptive x-drop) and K3 (extension
prep) launches, over the passes (the long-key counters are a subset of
the first two and are not added). 0 on the CPU, which launches none."""

from benchmark.cells import count_per_pass

COUNTERS = ("launch.xdrop_static", "launch.xdrop_adaptive",
            "launch.ext_prep")


def read(record):
    return count_per_pass(record, COUNTERS)
