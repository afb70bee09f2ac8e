"""Device mesh (counterpart of `mxnet_tpu/parallel/mesh.py`).

The JAX package names a `jax.sharding.Mesh` over its devices and lets
XLA emit the collectives. The port names the same axes over the
processes of a `torch.distributed` process group, one process per
device, and gives each axis larger than 1 its own process group (a
`torch.distributed.device_mesh.DeviceMesh` over those axes), which the
collectives of `parallel/` run on.

Axis vocabulary, as in the JAX package: pp (pipeline), dp (data), fsdp
(sharded data parallel), ep (experts), sp (sequence), tp (tensor);
ordered pp outermost, tp innermost.

Without a process group the world is one process (on the device of the
tensors it is given) and every axis has extent 1: no group is needed or
created. `local_mesh_devices(n)` is this process' device (n = 1), and
`make_mesh(devices=...)` takes one device per process of the world.
Sharding specs, manual axes, the sharded parameter modes and more than
one device in a process are not in the port yet (ROADMAP.md queue 1,
"Multi-device").
"""
from __future__ import annotations

import math

import torch.distributed as dist

from .. import context

__all__ = ["MeshPlan", "Mesh", "make_mesh", "set_mesh", "current_mesh",
           "mesh_axes", "local_mesh_devices"]

AXES = ("pp", "dp", "fsdp", "ep", "sp", "tp")

_current = {"mesh": None}


class MeshPlan:
    """A named parallelism plan: axis name -> size. Size -1 means 'absorb
    the remaining processes' (at most one axis may be -1)."""

    def __init__(self, dp=1, fsdp=1, tp=1, sp=1, pp=1, ep=1):
        self.axes = {"dp": dp, "fsdp": fsdp, "tp": tp, "sp": sp,
                     "pp": pp, "ep": ep}

    def resolve(self, n_devices):
        sizes = dict(self.axes)
        fill = [k for k, v in sizes.items() if v == -1]
        fixed = math.prod(v for v in sizes.values() if v != -1)
        if fill:
            if n_devices % fixed:
                raise ValueError(f"{n_devices} devices not divisible by {fixed}")
            sizes[fill[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"plan {sizes} needs {fixed} devices, have {n_devices}")
        return sizes


class Mesh:
    """Axis sizes in AXES order, this process' coordinate on each axis and
    the process group of each axis larger than 1 (None for the others)."""

    def __init__(self, shape, device_mesh=None):
        self.shape = {a: shape[a] for a in AXES}
        self._dm = device_mesh

    def group(self, axis):
        """The process group of `axis`, or None when its extent is 1."""
        return None if self.shape[axis] == 1 else self._dm.get_group(axis)

    def coordinate(self, axis):
        """This process' index along `axis`."""
        return 0 if self.shape[axis] == 1 else self._dm.get_local_rank(axis)

    def __repr__(self):
        return f"Mesh({self.shape})"


def _multi_device(what):
    return NotImplementedError(
        f"{what}: the port runs one device a process (ROADMAP.md queue 1, "
        "\"Multi-device\")")


def local_mesh_devices(n=None):
    """This process' devices: its one device (the entered context's, or
    the card), for n None or 1."""
    if n is not None and int(n) != 1:
        raise _multi_device(f"local_mesh_devices({n})")
    return [context.resolve(None)]


def make_mesh(plan=None, devices=None, **axis_sizes):
    """Build the mesh and make it current. `make_mesh(dp=-1)` (the
    default) spreads every process over data parallelism; `make_mesh(
    ep=2)` etc. The product of the sizes must equal the world size: the
    process group's, or 1 when there is none. `devices`, when given,
    holds one device a process of that world."""
    if plan is None:
        plan = MeshPlan(**{k: axis_sizes.get(k, 1) for k in AXES}) \
            if axis_sizes else MeshPlan(dp=-1)
    world = dist.get_world_size() if dist.is_initialized() else 1
    if devices is not None and len(devices) != world:
        raise _multi_device(f"make_mesh over {len(devices)} devices in a "
                            f"world of {world} processes")
    sizes = plan.resolve(world)
    dm = None
    split = [a for a in AXES if sizes[a] > 1]
    if split:
        from torch.distributed.device_mesh import init_device_mesh
        kind = "cuda" if dist.get_backend() == "nccl" else "cpu"
        dm = init_device_mesh(kind, tuple(sizes[a] for a in split),
                              mesh_dim_names=tuple(split))
    mesh = Mesh(sizes, dm)
    set_mesh(mesh)
    return mesh


def set_mesh(mesh):
    _current["mesh"] = mesh


def current_mesh():
    if _current["mesh"] is None:
        make_mesh()
    return _current["mesh"]


def mesh_axes(mesh):
    """{axis name: size} of a mesh, in axis order (JSON-able)."""
    return {str(k): int(v) for k, v in mesh.shape.items()}
