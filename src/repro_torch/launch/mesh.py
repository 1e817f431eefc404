"""Mesh construction and the shard-stream cluster entrypoint, in the
PyTorch port.  FUNCTIONS, not module-level constants: importing this
module touches no device and opens no socket.

The port's copy of ``repro.launch.mesh``.  Meshes are
``torch.distributed.device_mesh.DeviceMesh``es over the ranks of the
current ``torch.distributed`` group, built by ``dist.compat.make_mesh``
(which joins a group first if there is none); a rank is one device.
``init_stream_cluster`` joins the gloo group of one sharded scan.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.dist import compat


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """16x16 ranks over ("data", "model"); (2, 16, 16) over ("pod", "data",
    "model") when multi_pod (512 ranks).  Raises ValueError when the group
    has fewer ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return compat.make_mesh(shape, axes, device=device)


def make_local_mesh(axis_names=("data", "model"), *, device=None):
    """Mesh over every rank of the group (one when this process is alone).
    Puts all ranks on the first axis."""
    _, n = compat.init_process_group(device)
    shape = (n,) + (1,) * (len(axis_names) - 1)
    return compat.make_mesh(shape, axis_names, device=device)


def init_stream_cluster(
    coordinator: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> Tuple[int, int]:
    """Shard-stream entrypoint: join (or skip) a torch.distributed cluster.

    Returns (process_index, process_count).  With ``num_processes`` None or
    1 this is a no-op single-process run — the same ShardedStreamScanner
    code path then merges locally, so examples and tests need no mode
    switch.  Otherwise every process calls it with the same
    ``coordinator`` (``"host:port"``, where rank 0 listens) and its own
    ``process_id``, and they form one gloo group: the merge exchanges host
    arrays, which gloo carries whatever the devices.  Idempotent: a second
    call just reports the cluster shape."""
    import torch.distributed as dist

    if num_processes is not None and int(num_processes) > 1 and not dist.is_initialized():
        if coordinator is None or process_id is None:
            raise ValueError(
                "joining a cluster needs coordinator='host:port' and this "
                "process's process_id"
            )
        dist.init_process_group(
            "gloo", init_method=f"tcp://{coordinator}",
            world_size=int(num_processes), rank=int(process_id),
        )
    return compat.rank_and_world()
