"""device_ops_per_tick: device operations (kernels, copies, fills) the
traced slice ran, a tick: the rollout's and host dispatch's load."""


def read(data):
    if not data.get("ticks") or not data["ops"]:
        return None
    return data["ops"] / data["ticks"]
