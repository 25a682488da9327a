"""Readbacks a call makes that block the host until the card has
finished the work before them: the program's `gst.sync.*` spans over
the traced calls, per call (0.0 where the program marks spans and no
readback).  Nothing where the program marks no span."""

from sortbench import program_spans


def read(w):
    sp = program_spans.of(w)
    return sp.syncs / sp.calls if sp is not None else None
