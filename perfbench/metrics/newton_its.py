"""newton_its: Newton iterations per timed solve, summed over the levels of
both phases (SOL_feasibility.its + SOL_main.its), averaged over the solves."""


def read(rec):
    its = [s["its"] for s in rec.solves if s.get("its") is not None]
    return sum(its) / len(its) if its else None
