"""The card's peak of allocated memory over the window, in 10^9 bytes
(torch.cuda.max_memory_allocated after a reset at the window's start)."""


def read(record):
    if record["peak_bytes"] is None:
        return None
    return record["peak_bytes"] / 1e9
