"""Fleet scale-out over processes — counterpart of
slam_tpu/parallel/multihost.py (which replaces the reference's ROS
multi-machine `machine=` launch attribute, nasa_mapping.launch:3-14).

One process drives one device, PyTorch's idiom: `torch.distributed` with
NCCL between cards and gloo on the CPU stands in for XLA's single-
controller mesh. The topology rule is slam_tpu's: the robot (dp) axis is
pure data parallelism, whose only cross-device traffic is config 5's
shared-map all-reduce, so dp spans hosts; the spatial (sp) axis would
carry halo exchanges every tick, so an sp column stays inside one host.

    torchrun --nproc-per-node N -m slam_tpu_torch.mesh_scaling

starts N ranks on a machine with N cards; `init_distributed` picks up
torchrun's environment. NCCL needs one card a rank: two ranks on one card
raise here, and a run that shares one card between ranks asks for
backend="gloo", which reduces CUDA tensors through host memory.
"""

from __future__ import annotations

import os
import socket

import numpy as np
import torch
import torch.distributed as dist


def world_size() -> int:
    """The ranks of the process group, 1 without one."""
    return dist.get_world_size() if dist.is_initialized() else 1


def rank() -> int:
    """This process's rank, 0 without a process group."""
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device(device=None) -> torch.device:
    """`device`, or this rank's card: LOCAL_RANK (torchrun's), else the
    rank, modulo the visible cards, so that ranks beyond the card count
    share cards in turn. Raises without a card, as the entry points do."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is visible: pass device='cpu' to "
                           "run on the CPU")
    local = int(os.environ.get("LOCAL_RANK", rank()))
    return torch.device("cuda", local % torch.cuda.device_count())


def rank_generator(seed: int, device, r: int | None = None
                   ) -> torch.Generator:
    """A generator on `device` seeded from (seed, rank `r`, default this
    process's): each rank draws its own stream, and one process can replay
    any rank's."""
    r = rank() if r is None else r
    return torch.Generator(device).manual_seed(seed * 65536 + r)


def _card_identity(device: torch.device) -> str:
    props = torch.cuda.get_device_properties(device)
    uuid = getattr(props, "uuid", None)
    return str(uuid) if uuid is not None else (
        f"{socket.gethostname()}:{device.index}")


def refuse_shared_cards(store, me: int, n: int, identity: str) -> None:
    """Raise ValueError when two of the `n` ranks report one card: each rank
    writes its card's identity to the group's store under its rank and
    reads every other rank's (store traffic only, no collective, so it runs
    before NCCL builds a communicator that two ranks on one card would
    break)."""
    key = "slam_tpu_torch/card/{}"
    store.set(key.format(me), identity)
    cards = [store.get(key.format(r)).decode() for r in range(n)]
    shared = sorted({r for r in range(n) for q in range(n)
                     if q != r and cards[q] == cards[r]})
    if shared:
        raise ValueError(
            f"NCCL needs one card a rank, but ranks {shared} share a card "
            f"(identities {cards}): start one rank per card, or pass "
            f'backend="gloo" to run several ranks on one card')


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     backend: str | None = None) -> None:
    """Attach this process to the fleet's process group
    (torch.distributed.init_process_group).

    A no-op when a group already exists, or when the process runs alone:
    no coordinator and no WORLD_SIZE in the environment. Otherwise the
    group forms at `coordinator` ("host:port" for a TCP rendezvous, or a
    URL such as "file:///tmp/store") with num_processes ranks, this one
    process_id, or under torchrun's environment (env://). A failed init
    raises. The backend defaults to "nccl" when a card is visible, else
    "gloo"; with NCCL this rank's card becomes the current device, and two
    ranks on one card raise ValueError (never a quiet switch to gloo)."""
    if dist.is_initialized():
        return
    if coordinator is None and "WORLD_SIZE" not in os.environ:
        return
    if backend is None:
        backend = "nccl" if torch.cuda.is_available() else "gloo"
    if coordinator is None:
        dist.init_process_group(backend, init_method="env://")
    else:
        url = coordinator if "://" in coordinator else f"tcp://{coordinator}"
        dist.init_process_group(backend, init_method=url,
                                world_size=num_processes, rank=process_id)
    if backend == "nccl":
        dev = rank_device()
        try:
            refuse_shared_cards(dist.distributed_c10d._get_default_store(),
                                dist.get_rank(), dist.get_world_size(),
                                _card_identity(dev))
        except ValueError:
            dist.destroy_process_group()
            raise
        torch.cuda.set_device(dev)


def make_fleet_mesh(sp: int = 1, hosts: int | None = None,
                    n_ranks: int | None = None):
    """(dp, sp) mesh with dp spanning hosts and each sp column inside one
    host.

    With a process group of several ranks, a host is rank //
    LOCAL_WORLD_SIZE (torchrun numbers a host's ranks contiguously; a
    launch without that variable is one host), and sp must divide the
    ranks of a host. Without one, `hosts` virtual hosts split `n_ranks`
    (default: the world size, 1 alone) into contiguous groups, dp-major
    across them: the layout a real multi-host run would have, for tests in
    a single process."""
    from slam_tpu_torch.parallel.mesh import Mesh
    n = world_size() if n_ranks is None else n_ranks
    if world_size() > 1 and n_ranks is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", n))
        if n % per_host:
            raise ValueError(f"{n} ranks do not fill hosts of {per_host}")
    else:
        hosts = hosts or 1
        if n % hosts:
            raise ValueError(f"{n} ranks do not split into {hosts} hosts")
        per_host = n // hosts
    if per_host % sp:
        # a column across hosts would put every tick's halo exchange on
        # the network between hosts, the layout this module prevents
        raise ValueError(
            f"sp={sp} does not fit inside one host ({per_host} ranks a "
            "host): spatial halo exchanges must stay inside a host — lower "
            "sp or use more ranks a host")
    return Mesh(np.arange(n).reshape(n // sp, sp))


def host_local_batch(global_batch: int) -> int:
    """Robots a rank holds of a dp-sharded fleet: each rank builds only its
    own robots."""
    n = world_size()
    if global_batch % n:
        raise ValueError(f"a fleet of {global_batch} robots does not divide "
                         f"over {n} ranks")
    return global_batch // n
