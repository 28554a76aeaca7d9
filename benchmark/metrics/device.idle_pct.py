"""The card's idle share of the traced window, in %: 100 less the union
of its kernels', copies' and sets' intervals over the window's length."""


def read(record):
    t = record.get("trace")
    if not t or not t["window_s"] or t["busy_s"] is None:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
