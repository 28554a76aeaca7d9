"""Millions of candidate rows detection emits a second: the port's
`detect.rows` counter over the window, over the seconds of the detection
phases that detect.s_per_pass reads (overlapDetection, kmerCounting,
coverageEstimation; host clock). None where the record holds no such
counter (a port that does not count it) or no detection seconds."""

COUNTER = "detect.rows"
PHASES = ("overlapDetection", "kmerCounting", "coverageEstimation")


def read(record):
    counts = record.get("counts")
    if not counts or COUNTER not in counts:
        return None
    seconds = sum(record["phase_s"].get(p, 0.0) for p in PHASES)
    if not seconds:
        return None
    return counts[COUNTER] / 1e6 / seconds
