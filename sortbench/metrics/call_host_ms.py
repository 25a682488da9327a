"""Host milliseconds a call spends from its start to its return, before
the sync: the sum of the benchmark's `call` spans over the calls traced.
It covers the entry, the routing, the codec and the segmented dispatch
on the host (with any wait inside the call for the card)."""


def read(w):
    return w.call_host_s / w.calls * 1e3 if w.calls else None
