"""The share, in %, of the traced window's device-busy time in which a
collective of NCCL runs on the card (device operations whose name starts
with `nccl`, their union over the window): the exchange's part of a
distributed call, and its waits on the slowest rank.  Nothing where the
window holds no device time or no NCCL operation."""

from sortbench import trace


def read(w):
    nccl = trace._merge([(s, e) for s, e, name in w.op_intervals
                         if name.lower().startswith("nccl")])
    if w.busy_s <= 0 or not nccl:
        return None
    return sum(e - s for s, e in nccl) / 1e6 / w.busy_s * 100.0
