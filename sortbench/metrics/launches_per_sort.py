"""Kernel launches on the card per call, over the traced window."""


def read(w):
    return w.kernels / w.calls if w.kernels and w.calls else None
