"""setup_s: process start to the window's start: imports, kernel load
(and build on a checkout's first run), geometry, data, warm-up solve."""


def read(rec):
    return rec.setup_s
