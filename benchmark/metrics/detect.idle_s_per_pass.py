"""Seconds a pass the card idles inside the port's detection phase: the
idle time of the traced window (no kernel, copy or set on the card)
inside its `bella.overlapDetection` spans (benchmark/program_spans.py),
over the passes; None where the card recorded no work or the port opened
no such span."""

SPAN = "bella.overlapDetection"


def read(record):
    t = record.get("trace")
    if (not t or t["busy_s"] is None or not record["passes"]
            or SPAN not in t.get("idle_in_span", {})):
        return None
    return t["idle_in_span"][SPAN] / record["passes"]
