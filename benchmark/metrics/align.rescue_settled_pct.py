"""The cascade's yield, in %: the pairs that settled inside a wider band
(`cascade.settled`) over the pairs it re-extended (`cascade.extended`),
summed over its levels and the window; None where it extended none (the
adaptive aligner has no cascade)."""

from benchmark.cells import counted


def read(record):
    extended = counted(record, ("cascade.extended",))
    if not extended:
        return None
    return 100.0 * counted(record, ("cascade.settled",)) / extended
