"""Production mesh construction.

Counterpart of ``repro/launch/mesh.py`` over ``torch.distributed``: a
``DeviceMesh`` needs an initialised default process group of as many ranks
as the mesh has devices (the dry run initialises a ``fake`` one, which
moves nothing).  A FUNCTION, so importing this module touches no process
group.  Single pod: 16 x 16 = 256 devices (data, model).  Multi-pod:
2 x 16 x 16 = 512 devices (pod, data, model).
"""

from __future__ import annotations


def make_production_mesh(*, multi_pod: bool = False, device_type="cpu"):
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=all_axes(multi_pod))


def batch_axes(multi_pod: bool):
    """Mesh axes that shard the batch/query dimension."""
    return ("pod", "data") if multi_pod else ("data",)


def all_axes(multi_pod: bool):
    """Every mesh axis (the flattened 'server' axis for BatANN serving)."""
    return ("pod", "data", "model") if multi_pod else ("data", "model")


def axis_size(mesh, name: str) -> int:
    """The number of devices along mesh axis ``name``."""
    return mesh.size(mesh.mesh_dim_names.index(name))
