"""geometry_s: the fem2d / fem3d call that builds the geometry on the card,
host clock with a device synchronise after it."""


def read(rec):
    return rec.geometry_s
