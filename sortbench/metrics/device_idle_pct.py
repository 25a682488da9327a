"""The share of the traced window's wall time, in %, in which no device
operation ran on the card."""


def read(w):
    if w.busy_s <= 0 or w.wall_s <= 0:
        return None
    return (1.0 - w.busy_s / w.wall_s) * 100.0
