"""nd_symbolic_s: host seconds in NDSymbolic construction over the run
(each ND level's, built by the warm-up), from the wrapper around the class."""


def read(rec):
    return sum(rec.symbolic_s) if rec.symbolic_s else None
