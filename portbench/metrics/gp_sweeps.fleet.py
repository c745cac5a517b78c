"""gp_sweeps.fleet: INSAC sweeps a sector of ground segmentation ran, mean
over the traced slice's sectors: the GP sector kernel's own count, which
each (robot, sector) block adds on the card when its sweeps end
(`ground.gp_sweeps`), over the sectors of those calls
(`ground.gp_problems`). The kernel counts only while a profiler records,
so the totals are the traced slice's. A sector stops when it adopts
nothing or has nothing left to adopt, so the configuration's
max_insac_sweeps means the early exit never engaged, and a sector that
needs no sweep (too few seeds, or every valid slot a seed) counts 0. A
program without the kernel's counters reads nothing."""

from portbench.harness import program


def read(data):
    c = program.totals()
    if c is None or not c.get("ground.gp_problems", 0):
        return None
    return c.get("ground.gp_sweeps", 0) / c["ground.gp_problems"]
