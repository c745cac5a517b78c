"""fit_iterations.fleet: fit iterations a robot's registration ran, mean
over the traced slice's fits: K1's and K3's own count, which each robot
adds on the card when its fit ends (`k1.fit_iterations`,
`k3.fit_iterations`), over the robots of those calls (`k1.fit_problems`,
`k3.fit_problems`). The kernels count only while a profiler records, so
the totals are the traced slice's. A change in registration_ms that this
leaves alone is the kernels' speed, not the fleet's convergence."""

from portbench.harness import program


def read(data):
    c = program.totals()
    if c is None:
        return None
    problems = c.get("k1.fit_problems", 0) + c.get("k3.fit_problems", 0)
    if not problems:
        return None
    return (c.get("k1.fit_iterations", 0) +
            c.get("k3.fit_iterations", 0)) / problems
