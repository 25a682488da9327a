"""The share, in %, of the traced window's device-busy time taken by the
work the program enqueues inside its `gst.composite.gather`,
`gst.payload.split` and `gst.payload.join` spans: the codes and payload
planes read out by the composite's permutation, and a 64-bit payload
split into two planes and joined back (span_share.py ties a device
operation to a span).  Nothing where the program marks none of them."""

from sortbench import span_share


def read(w):
    return span_share.share(w, ("gst.composite.gather", "gst.payload.split",
                                "gst.payload.join"))
