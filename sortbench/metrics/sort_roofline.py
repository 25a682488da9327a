"""The call's share of its roofline, in %: the least time the bytes of one
call take at the card's published HBM bandwidth, over the device-busy
time a call (the union of device operations in the traced window over its
calls).  Nothing is read where the trace has no device time or the card
has no published peak."""


def read(w):
    if w.busy_s <= 0 or not w.peak_bytes_per_s or not w.calls:
        return None
    return (w.bytes / w.peak_bytes_per_s) / w.busy_s * 100.0
