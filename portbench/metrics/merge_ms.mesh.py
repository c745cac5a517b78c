"""merge_ms.mesh: the shared map's merge over the cards, the median
device ms of an NCCL all-reduce kernel on rank 0's traced slice (one a
macro; a launch that waited for a rank still starting its profiler
reads far longer, hence the median, not the sum)."""

import statistics


def read(data):
    us = [d for name, ds in data.get("launches_us", {}).items()
          if "nccl" in name for d in ds]
    if not us:
        return None
    return statistics.median(us) / 1e3
