"""Extensions an x-drop launch runs: the port's `xdrop.extensions` counter
over its K1 and K2 launch counters, in the window; None where nothing
was launched (on the CPU the plain versions run the extensions)."""

from benchmark.cells import counted

LAUNCHES = ("launch.xdrop_static", "launch.xdrop_adaptive")


def read(record):
    launches = counted(record, LAUNCHES)
    if not launches:
        return None
    return counted(record, ("xdrop.extensions",)) / launches
