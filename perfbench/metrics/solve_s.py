"""solve_s: the window, first solve's start to the last one's end (host
clock, device synchronised at both ends), over the solves in it."""


def read(rec):
    return rec.window_s / len(rec.solves)
