"""Chains detection runs a pass of the window: the port's `detect.ranges`
counter over the passes. 1 where one chain takes every candidate row;
more where the rows outgrow the chain's share of the card's memory and
are emitted and chained one range of H reads at a time. None where the
record holds no such counter (a port that does not count it) or no
pass."""

COUNTER = "detect.ranges"


def read(record):
    counts = record.get("counts")
    if not counts or COUNTER not in counts or not record["passes"]:
        return None
    return counts[COUNTER] / record["passes"]
