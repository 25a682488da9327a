"""Host milliseconds a call spends deciding its route: the program's
outermost `gst.dispatch.*` spans (AUTO's route choice, the segmented
sort's route choice and window plan) summed over the traced calls, per
call.  Nothing where the program marks no span."""

from sortbench import program_spans


def read(w):
    sp = program_spans.of(w)
    return sp.dispatch_s / sp.calls * 1e3 if sp is not None else None
