"""The share of the x-drop extensions that ran in K1's grouped tile (the
static mode's int32-key launches at band <= 256: several extensions a
warp), in %: the port's `xdrop.grouped_extensions` counter over its
`xdrop.extensions`, in the window. 0 where no launch took the tile (the
adaptive aligner). None where the record holds no such counter (a port
that does not count it, or no launch) or no extension ran."""

COUNTER = "xdrop.grouped_extensions"


def read(record):
    counts = record.get("counts")
    if not counts or COUNTER not in counts:
        return None
    extensions = counts.get("xdrop.extensions", 0)
    if not extensions:
        return None
    return 100.0 * counts[COUNTER] / extensions
