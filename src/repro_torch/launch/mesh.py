"""Device meshes over ``torch.distributed`` (counterpart of the non-XLA
part of ``repro/launch/mesh.py``).

JAX drives N devices from one controller; here N processes each drive one
device (one rank a device, ``torchrun --nproc-per-node N``), and a mesh is
a :class:`~torch.distributed.device_mesh.DeviceMesh` over their process
group with axes ``("data", "model")``: rank ``r`` of an ``(R, C)`` mesh
sits at ``(r // C, r % C)``, the row-major order in which JAX lays out the
devices of ``make_mesh`` (so ``axis_index`` over both axes is the rank).
The reference's named axes become the mesh's sub-groups
(:func:`axis_group`): ``dp_axes`` carry the batch, ``all_axes`` every
device. A mesh may hold fewer ranks than the process group (the first
``R * C``, as the reference's test meshes take the first devices); the
ranks outside it do no work on it. A mesh larger than the group raises,
naming the fix.

``make_cache_mesh`` is the striped HPS L1's 1-D device list: plain torch
devices, not ranks, since one serving process reads the stripes of every
device it is given (an explicit list may repeat a device).
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.configs.base import MeshConfig


def _prod(xs: Sequence[int]) -> int:
    n = 1
    for x in xs:
        n *= int(x)
    return n


def world_size() -> int:
    """Ranks in the process group (1 when none is initialized)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def launch_hint(n: int) -> str:
    """How to start ``n`` ranks: the fix an oversubscribed mesh names."""
    return (f"launch one process per device with `torchrun "
            f"--nproc-per-node {n} ...` (or call "
            f"torch.distributed.init_process_group with world_size={n} "
            "in each process) before building the mesh")


def make_test_mesh(shape: Sequence[int] = (1, 1),
                   axes: Sequence[str] = ("data", "model"), *,
                   device_type: Optional[str] = None) -> DeviceMesh:
    """A ``shape`` mesh named ``axes`` over the first ``prod(shape)`` ranks
    of the initialized process group, on ``device_type`` (``cuda`` under
    NCCL, ``cpu`` under gloo, unless given). Every rank of the group must
    call it with the same arguments (sub-groups are made collectively)."""
    shape, axes = tuple(int(s) for s in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         "length")
    want = _prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {shape} mesh needs an initialized process group; "
            + launch_hint(want))
    world = dist.get_world_size()
    if want > world:
        raise RuntimeError(
            f"a {shape} mesh asks for {want} ranks but the process group "
            f"has {world}; " + launch_hint(want))
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    if want == world:
        return init_device_mesh(device_type, shape, mesh_dim_names=axes)
    mesh = DeviceMesh(device_type, torch.arange(want).view(shape),
                      mesh_dim_names=axes)
    # the flattened ``all_axes`` group of a mesh smaller than the world
    mesh.repro_all_group = dist.new_group(list(range(want)))
    return mesh


def auto_mesh(shape: Optional[Sequence[int]]) -> Optional[DeviceMesh]:
    """The mesh a launcher's ``--mesh`` (or ``Solver.mesh_shape``) asks
    for: ``shape`` over the process group's ranks, ``(world, 1)`` when
    unset under a group of several ranks, and no mesh (one device)
    otherwise."""
    if shape is None:
        world = world_size()
        return make_test_mesh((world, 1)) if world > 1 else None
    if _prod(shape) == 1 and not dist.is_initialized():
        return None
    return make_test_mesh(tuple(shape))


def make_cache_mesh(stripes: int, devices: Optional[Sequence] = None
                    ) -> List[torch.device]:
    """The striped L1's device list: as many of ``devices`` (every card
    when omitted, else the CPU) as tile ``stripes`` evenly, so stripe ``i``
    lands on device ``i * size // stripes``; one device when the stripe
    and device counts do not divide (the reference's degrade rule)."""
    if devices is None:
        devices = ([f"cuda:{i}" for i in range(torch.cuda.device_count())]
                   or ["cpu"])
    devices = [torch.device(d) for d in devices]
    size = min(stripes, len(devices))
    while size > 1 and stripes % size:
        size -= 1
    return devices[:max(size, 1)]


def in_mesh(mesh: DeviceMesh) -> bool:
    """Whether this rank is one of ``mesh``'s."""
    return mesh.get_coordinate() is not None


def mesh_shape(mesh: DeviceMesh) -> Dict[str, int]:
    """``{axis: size}`` in axis order (the reference's ``mesh.shape``)."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def mesh_size(mesh: DeviceMesh) -> int:
    return mesh.mesh.numel()


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """This rank's device on ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def dp_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    """Axes carrying the batch dimension (everything except "model")."""
    return tuple(a for a in mesh.mesh_dim_names if a != "model")


def all_axes(mesh: DeviceMesh) -> Tuple[str, ...]:
    return tuple(mesh.mesh_dim_names)


def mesh_config_for(mesh: DeviceMesh) -> MeshConfig:
    return MeshConfig(tuple(mesh.mesh.shape), tuple(mesh.mesh_dim_names))


def axis_size(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    shape = mesh_shape(mesh)
    return _prod(shape[a] for a in axes)


def axis_index(mesh: DeviceMesh, axes: Sequence[str]) -> int:
    """This rank's row-major index over ``axes`` (``jax.lax.axis_index``
    of an axis tuple)."""
    shape = mesh_shape(mesh)
    idx = 0
    for a in axes:
        idx = idx * shape[a] + mesh.get_local_rank(a)
    return idx


def axis_group(mesh: DeviceMesh, axes: Sequence[str]):
    """The process group spanning ``axes`` through this rank, its ranks in
    :func:`axis_index` order: one axis's sub-group, or every rank of the
    mesh for all of its axes. Kept on the mesh after the first call: a
    ``DeviceMesh`` slice is slow on the host, and a model's layers each
    ask for theirs."""
    axes = tuple(axes)
    groups = getattr(mesh, "repro_groups", None)
    if groups is None:
        groups = mesh.repro_groups = {}
    if axes not in groups:
        groups[axes] = _axis_group(mesh, axes)
    return groups[axes]


def _axis_group(mesh: DeviceMesh, axes: Tuple[str, ...]):
    names = tuple(mesh.mesh_dim_names)
    if len(axes) == 1:
        return mesh[axes[0]].get_group()
    if axes != names:
        raise ValueError(f"axes {axes} are neither one axis nor all of "
                         f"{names}")
    if hasattr(mesh, "repro_all_group"):
        return mesh.repro_all_group
    if mesh_size(mesh) != world_size():
        raise ValueError("a mesh smaller than the process group must come "
                         "from make_test_mesh")
    return dist.group.WORLD
