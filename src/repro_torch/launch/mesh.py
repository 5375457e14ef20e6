"""The host mesh of the distributed layer.

``make_host_mesh`` builds a ``torch.distributed`` ``DeviceMesh`` with dims
("data", "model") over the initialised world: one process per device
(``torchrun``, or ``init_process_group`` with an explicit address, rank and
world size). The reference's ``make_production_mesh`` (a 256- or 512-chip
TPU pod) has no counterpart here.
"""
from __future__ import annotations


def make_host_mesh(model_axis: int = 1, *, device_type: str = "cuda"):
    """A (world // model_axis, model_axis) mesh named ("data", "model")
    over every rank of the initialised default process group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError("make_host_mesh: initialise torch.distributed "
                           "first (torchrun, or init_process_group)")
    world = dist.get_world_size()
    if world % model_axis:
        raise ValueError(f"model axis {model_axis} does not divide the "
                         f"world of {world}")
    return init_device_mesh(device_type, (world // model_axis, model_axis),
                            mesh_dim_names=("data", "model"))
