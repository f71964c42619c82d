"""Multi-host process bootstrap — SURVEY.md §7.8 ("multi-host process
bootstrap via ``jax.distributed.initialize``"; BASELINE.json config #5,
"N>=2 hosts"). The reference is single-GPU and has no analogue; this is the
mandated new-design entry point.

Launch recipe (one process per host; the triplet is passed explicitly,
or discovered by JAX's cluster auto-detection where one exists):

    # host 0 (also runs the coordinator service)
    COORDINATOR_ADDRESS=host0:9876 NUM_PROCESSES=4 PROCESS_ID=0 \
        python -m benchmark_spgemm_using_csr_tpu suite:er_medium \
            --multihost --mesh 32 --schedule halo
    # host i
    COORDINATOR_ADDRESS=host0:9876 NUM_PROCESSES=4 PROCESS_ID=$i \
        python -m benchmark_spgemm_using_csr_tpu ... --multihost ...

After ``init_multihost()``, ``jax.devices()`` is the GLOBAL device list;
``global_mesh()`` builds the 1D row mesh over it and every schedule in
``parallel.dist`` / ``parallel.halo`` works unchanged (shard_map over a
multi-host mesh inserts cross-host collectives; the halo exchange's
all_to_all rides the same path). The wiring is unit-tested with a
1-process initialize (tests/test_bootstrap.py) and the schedules with the
8-device virtual CPU mesh; multi-host runs have not been made.
"""
from __future__ import annotations

import dataclasses
import logging
import os

log = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class HostTopology:
    process_id: int
    process_count: int
    local_devices: int
    global_devices: int
    coordinator: str | None


def init_multihost(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    local_device_ids: list[int] | None = None,
) -> HostTopology:
    """Initialize the JAX distributed runtime and return the topology.

    Arguments default to the COORDINATOR_ADDRESS / NUM_PROCESSES /
    PROCESS_ID environment variables (and to JAX's own cluster
    auto-detection, where all three may be omitted). Idempotent: a second call
    in the same process returns the existing topology.
    """
    import jax

    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS"
    )
    if num_processes is None and os.environ.get("NUM_PROCESSES"):
        num_processes = int(os.environ["NUM_PROCESSES"])
    if process_id is None and os.environ.get("PROCESS_ID"):
        process_id = int(os.environ["PROCESS_ID"])

    already = jax._src.distributed.global_state.client is not None
    if not already:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
            local_device_ids=local_device_ids,
        )
    topo = HostTopology(
        process_id=jax.process_index(),
        process_count=jax.process_count(),
        local_devices=len(jax.local_devices()),
        global_devices=len(jax.devices()),
        coordinator=coordinator_address,
    )
    log.info(
        "multihost%s: process %d/%d, %d local / %d global devices",
        " (already initialized)" if already else "",
        topo.process_id, topo.process_count,
        topo.local_devices, topo.global_devices,
    )
    return topo


def global_mesh(n_devices: int | None = None, axis: str = "rows"):
    """1D row mesh over the GLOBAL device list (call after init_multihost).

    Shardings laid out on this mesh keep shard-to-shard traffic on ICI
    within a slice; DCN carries only the inter-slice edges XLA assigns."""
    import jax
    import numpy as np
    from jax.sharding import Mesh

    devs = jax.devices()
    n = n_devices or len(devs)
    return Mesh(np.array(devs[:n]), (axis,))


def shutdown():
    """Tear down the distributed runtime (test hygiene; safe if not up)."""
    import jax

    if jax._src.distributed.global_state.client is not None:
        jax.distributed.shutdown()
