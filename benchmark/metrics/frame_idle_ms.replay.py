"""Device-idle milliseconds inside a frame: for each of the window's
``lcd.frame`` spans (the program's gating and dispatch of one frame), its
length less the union of the device's rows clipped to it, summed, over the
number of those spans. None off a card, or where the program has no such
span."""

from benchmark import program_trace


def read(run, trace):
    frames = program_trace.spans(trace, "lcd.frame")
    if not frames or not program_trace.on_card(run, trace):
        return None
    return sum(program_trace.idle_us(trace, frames)) / len(frames) / 1e3
