"""The share, in %, of the traced window's device-busy time taken by the
work the program enqueues inside its `gst.composite.sort` spans: the
stable sort of the segmented composite key (span_share.py ties a device
operation to a span).  Nothing where the program marks no such span."""

from sortbench import span_share


def read(w):
    return span_share.share(w, ("gst.composite.sort",))
