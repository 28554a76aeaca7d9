"""The x-drop kernels' share of their roofline: the least time the traced
passes' alignment outputs need (peaks.xdrop_least_s, at the configured
band), over the device time of every kernel the profiler recorded
inside the alignment driver's spans, in %."""

from benchmark import peaks


def read(record):
    t = record.get("trace")
    if not t or not t["align_kernel_s"]:
        return None
    least = peaks.xdrop_least_s(t["aligned_bases"], t["band"],
                                t["packed_bytes"], record["kind"])
    if least is None:
        return None
    return 100.0 * least / t["align_kernel_s"]
