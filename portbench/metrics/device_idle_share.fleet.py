"""device_idle_share.fleet: 100 (1 - kernel-busy ms a tick under the
profiler / ms a tick of the same run's unprofiled window over its last
macros, which the traced slice follows: a fleet's tick grows as its maps
fill). Busy leaves out the collectives' kernels, which spin on the card
while a rank waits for the others (merge_ms.mesh reads them)."""

from portbench.harness.layers import collective_us


def read(data):
    if not data.get("ticks") or not data.get("wall_ms_per_tick") \
            or not data["busy_us"]:
        return None
    busy = (data["busy_us"] - collective_us(data)) / 1e3 / data["ticks"]
    return 100.0 * (1.0 - busy / data["wall_ms_per_tick"])
