"""Corpus bases a second: the bases of every pass the window completed,
over the host-clock seconds from the window's start to the end of its
last pass."""


def read(record):
    if not record["passes"] or record["window_s"] <= 0:
        return None
    return record["passes"] * record["corpus_bases"] / record["window_s"]
