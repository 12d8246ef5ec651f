"""Seconds from the process's start to the window's: imports, the card's
start-up, kernel libraries built or loaded, data and weights made from
the seed, the model converted and packed, and the warm-up batches."""


def read(run):
    return run.window.t0 - run.t_start
