"""Device-mesh construction and sharding helpers.

The reference has zero parallelism (one JS thread, SURVEY.md §2); this module
is the framework's scaling substrate: batched multi-stream decode lays out
  * ``dp``  — independent AVI streams (the data-parallel axis), and
  * ``gop`` — keyframe-delimited GOPs within a stream (the sequence/context-
    parallel axis; GOPs are independent decode chains, the reference's only
    independent unit — DataLoader.GetNearestKeyframe, DataLoader.hx:125-132)
over a `jax.sharding.Mesh`.  XLA derives the collectives from sharding
annotations (NCCL on GPUs); nothing here issues explicit collective calls.
The cards of one host are joined all to all, so the mesh follows the
algorithm, not a physical topology.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P


def make_mesh(
    dp: Optional[int] = None,
    gop: int = 1,
    devices: Optional[Sequence[jax.Device]] = None,
) -> Mesh:
    """Build a (dp, gop) mesh over the available devices.

    Multi-host: `jax.devices()` already spans all processes after
    `jax.distributed.initialize()`; keep `gop` within one host's device count
    so GOP-chain collectives stay on the host's own links while the dp axis
    may cross hosts (streams are independent — no cross-host traffic on
    dp)."""
    devices = list(devices if devices is not None else jax.devices())
    n = len(devices)
    if dp is None:
        dp = n // gop
    assert dp * gop == n, f"dp({dp})*gop({gop}) != ndevices({n})"
    arr = np.array(devices).reshape(dp, gop)
    return Mesh(arr, ("dp", "gop"))


def init_multihost(coordinator: Optional[str] = None,
                   num_processes: Optional[int] = None,
                   process_id: Optional[int] = None) -> None:
    """Multi-host initialization wrapper — the framework's equivalent of
    the reference's single transport (SURVEY.md §5.8: XHR only; here
    jax.distributed handles cross-host coordination and XLA places the
    collectives).  Pass all three arguments where no cluster manager
    announces them."""
    import jax

    kwargs = {}
    if coordinator is not None:
        kwargs["coordinator_address"] = coordinator
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


def stream_sharding(mesh: Mesh) -> NamedSharding:
    """[B, T, ...] tensors: streams over dp, time/GOP over gop."""
    return NamedSharding(mesh, P("dp", "gop"))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """[B, ...] tensors: streams over dp, replicated over gop."""
    return NamedSharding(mesh, P("dp"))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())
