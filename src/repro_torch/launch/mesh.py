"""The shard-stream cluster entrypoint and the production mesh's device
check, in the PyTorch port.

The port's counterpart of ``repro.launch.mesh.init_stream_cluster``: the
processes of one sharded scan join a ``torch.distributed`` gloo group.  Of
the reference's meshes only the device count of the production mesh is
here: training runs on one device until the multi-device layer (the spec
tables of ``dist/sharding.py``) is ported.  Importing this module touches
no device and opens no socket.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.dist import compat


def make_production_mesh(*, multi_pod: bool = False):
    """The reference's 16x16 mesh (2x16x16 with multi_pod) needs 256 (512)
    devices: raise on fewer, as the reference's mesh construction does.
    With enough devices it still raises: the port has no sharded model
    path yet."""
    import torch

    need = 512 if multi_pod else 256
    have = torch.cuda.device_count()
    if have < need:
        raise ValueError(f"the production mesh needs {need} devices; this host has {have}")
    raise NotImplementedError("the production mesh waits for the port's multi-device layer")


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
