"""Frames delivered (``on_frames``, the card's frames ready) inside the
window, over the window's seconds."""

from portbench.stats import rate


def read(run):
    return rate(run.frames, run.window_s)
