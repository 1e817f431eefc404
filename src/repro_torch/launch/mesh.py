"""The shard-stream cluster entrypoint, in the PyTorch port.

The port's counterpart of ``repro.launch.mesh.init_stream_cluster``: the
processes of one sharded scan join a ``torch.distributed`` gloo group.  The
reference's production meshes belong to the training scaffold and are not
part of this module.  Importing it touches no device and opens no socket.
"""

from __future__ import annotations

from typing import Optional, Tuple

from repro_torch.dist import compat


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
