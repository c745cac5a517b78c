"""device_idle_share.live: 100 (1 - kernel-busy ms / latency ms), summed
over the traced live frames."""


def read(data):
    if not data.get("frames") or not data.get("latency_ms") \
            or not data["busy_us"]:
        return None
    return 100.0 * (1.0 - data["busy_us"] / 1e3 / data["latency_ms"])
