"""Seconds from the start of the process to the window: imports, the
card's initialisation, the kernel and native libraries loaded (built
in the first run of a checkout), the corpus made and written, and the
warm-up pass."""


def read(record):
    return record["setup_s"]
