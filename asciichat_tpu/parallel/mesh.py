"""Device mesh + sharding layout for multi-chip scaling.

The reference scales by spawning 2 render threads per client on one host
(src/server/render.c:16-38, "linear to 9+ clients"). The device scaling
axes (SURVEY.md §5) are clients x pixels: we shard the CLIENT batch over a
"clients" mesh axis (data parallel — each device renders its clients' frames)
and optionally the cell-row axis over a "space" axis (spatial parallel — rows
of the same frame land on different devices). Collectives are never written
by hand: sharding annotations + jit let XLA insert all-gathers (NCCL over
NVLink on GPUs) where the compositor needs every client's frame. The GPUs of
one host are joined all to all, so the mesh follows the algorithm, not a
topology.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

CLIENTS_AXIS = "clients"
SPACE_AXIS = "space"


def make_mesh(n_devices: int | None = None, space: int = 1, devices=None) -> Mesh:
    """1D ("clients",) or 2D ("clients", "space") mesh.

    ``devices=None`` means the default backend's devices; asking for more
    than it has raises. Callers that want the virtual CPU pool pass
    ``jax.devices("cpu")`` explicitly."""
    if devices is None:
        devices = jax.devices()
    n = n_devices or len(devices)
    if len(devices) < n:
        raise ValueError(f"need {n} devices, have {len(devices)} "
                         f"({devices[0].platform})")
    devices = np.asarray(devices[:n])
    if space > 1:
        if n % space:
            raise ValueError(f"{n} devices not divisible by space={space}")
        return Mesh(devices.reshape(n // space, space), (CLIENTS_AXIS, SPACE_AXIS))
    return Mesh(devices.reshape(n), (CLIENTS_AXIS,))


def serving_space_axis(n_devices: int) -> int:
    """The space-axis extent for the production mesh.

    ``ASCIICHAT_MESH_SPACE=K`` (K>1) splits the mesh into a 2D clients×space
    layout: each group's receiver batch shards over clients//K chips and the
    CELL-ROW axis of every frame shards over K chips (SURVEY §5's
    *pixels × clients* axes) — the layout for tall frames or
    few-clients/many-chips deployments, value-exact vs 1D by
    __graft_entry__.dryrun_multichip and tests/test_server_mesh.py.
    An extent that doesn't divide the device count is refused loudly (a
    silently dropped axis would serve a different layout than configured).
    """
    import os

    raw = os.environ.get("ASCIICHAT_MESH_SPACE", "")
    if not (raw.isdigit() and int(raw) > 1):
        return 1
    space = int(raw)
    if n_devices % space != 0:
        from asciichat_tpu.utils.logsys import get_logger

        get_logger("mesh").warning(
            "ASCIICHAT_MESH_SPACE=%d does not divide %d devices; "
            "serving on a 1D clients mesh", space, n_devices)
        return 1
    return space


def serving_mesh() -> Mesh | None:
    """The PRODUCTION server's mesh (apps/server.py render tick).

    - ``ASCIICHAT_FORCE_MESH=N`` (N>1) forces an N-device mesh over the
      virtual CPU device pool (apps/main.py injects
      ``--xla_force_host_platform_device_count=N`` before backend init) —
      the way to exercise the sharded serving path without N real chips.
    - ``ASCIICHAT_MESH_SPACE=K`` (K>1) makes it 2D clients×space
      (serving_space_axis above) — applies to forced AND real meshes.
    - Otherwise: a mesh over all visible ACCELERATOR devices when more than
      one exists. Plain CPU multi-device pools are never auto-meshed (they
      only exist when a test harness forces them; sharding over virtual CPU
      devices is a correctness tool, not a speedup).
    - None => single-device serving.
    """
    import os

    force = os.environ.get("ASCIICHAT_FORCE_MESH", "")
    if force.isdigit() and int(force) > 1:
        n = int(force)
        devices = jax.devices("cpu")
        if len(devices) < n:
            return None  # flag not injected before backend init; stay single
        return make_mesh(n, space=serving_space_axis(n), devices=devices)
    devices = jax.devices()
    if len(devices) > 1 and devices[0].platform != "cpu":
        n = len(devices)
        return make_mesh(n, space=serving_space_axis(n), devices=devices)
    return None


def client_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading client/batch axis; everything else replicated."""
    return NamedSharding(mesh, P(CLIENTS_AXIS))


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def client_space_sharding(mesh: Mesh) -> NamedSharding:
    """[C, rows, ...]: clients over the clients axis, rows over space axis."""
    if SPACE_AXIS in mesh.axis_names:
        return NamedSharding(mesh, P(CLIENTS_AXIS, SPACE_AXIS))
    return NamedSharding(mesh, P(CLIENTS_AXIS))
