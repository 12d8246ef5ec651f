"""Frames whose result reached the host inside the window, over the
window's seconds: all the work over all the time of the window."""


def read(run):
    w = run.window
    return sum(n for _, n, _ in w.in_window()) / (w.t1 - w.t0)
