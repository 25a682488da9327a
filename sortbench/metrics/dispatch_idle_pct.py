"""The share of the traced window's wall time, in %, in which the card
is idle while the host is inside one of the program's `gst.dispatch.*`
spans (the intersection of the idle intervals with the outermost
dispatch spans).  Nothing where the program marks no span."""

from sortbench import program_spans


def read(w):
    sp = program_spans.of(w)
    if sp is None or sp.wall_s <= 0:
        return None
    return sp.dispatch_idle_s / sp.wall_s * 100.0
