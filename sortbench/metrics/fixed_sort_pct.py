"""The share, in %, of the traced window's device-busy time taken by the
work the program enqueues inside its `gst.fixed.sort` spans: the batched
sort of the segmented fixed-length route's (S, L) rows (span_share.py ties
a device operation to a span).  Nothing where the program marks no such
span."""

from sortbench import span_share


def read(w):
    return span_share.share(w, ("gst.fixed.sort",))
