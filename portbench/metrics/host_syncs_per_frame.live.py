"""host_syncs_per_frame.live: host syncs a traced live frame makes, counted
under torch.cuda.set_sync_debug_mode("warn") (the fit's converged reads
and the pose's read to the host)."""


def read(data):
    if not data.get("frames") or "syncs" not in data:
        return None
    return data["syncs"] / data["frames"]
