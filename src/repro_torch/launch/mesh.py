"""Device meshes of the port, and the card's figures for the roofline.

The walker fleet's mesh (:func:`make_walker_mesh`) is a 1-D
``torch.distributed.device_mesh.DeviceMesh`` over the processes of an
initialised process group, its one dimension named ``"data"``: the mesh
axis the ``walker`` logical axis of ``repro_torch.sharding.rules`` maps
to, so a W-walker fleet splits its walks over the ranks and the periodic
model average is one all-reduce along ``"data"``
(``repro_torch.walk_sgd.fleet``).

The production meshes (256 devices a pod, 512 over two pods) and the smoke
mesh cannot be built on one machine; :func:`make_production_mesh` and
:func:`make_smoke_mesh` return an :class:`AbstractMesh` (axis names and
shape, no devices), which the spec rules read as they read a
``DeviceMesh``.

Nothing here touches a device or a process group when the module is
imported.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import torch

__all__ = [
    "AbstractMesh",
    "make_production_mesh",
    "make_smoke_mesh",
    "make_walker_mesh",
    "fake_device_mesh",
    "mesh_sizes",
    "HW",
]


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """A mesh's axis names and shape, without devices."""

    shape: tuple
    axis_names: tuple

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"shape {self.shape} and axis names "
                             f"{self.axis_names} differ in length")


def mesh_sizes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or an :class:`AbstractMesh`."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:  # a torch DeviceMesh (its shape, not its rank tensor)
        return dict(zip(names, tuple(mesh.shape)))
    return dict(zip(mesh.axis_names, tuple(mesh.shape)))


def make_production_mesh(*, multi_pod: bool = False, model_parallel: int = 16):
    """The production mesh, 256 devices a pod: ``(data, model)`` with
    ``model_parallel`` on ``model`` (16x16 by default; 32x8 for archs
    whose head counts do not divide 16), and ``(pod=2, data, model)``
    over two pods.  Abstract: axis names and shape."""
    if 256 % model_parallel:
        raise ValueError(f"model_parallel={model_parallel} does not divide 256")
    data = 256 // model_parallel
    if multi_pod:
        return AbstractMesh((2, data, model_parallel), ("pod", "data", "model"))
    return AbstractMesh((data, model_parallel), ("data", "model"))


def make_smoke_mesh():
    """The one-device mesh of the smoke tests, with the production axis
    names.  Abstract: axis names and shape."""
    return AbstractMesh((1, 1), ("data", "model"))


def make_walker_mesh(num_devices: int | None = None, *, device_type: str = "cuda"):
    """The fleet's 1-D mesh: the ranks of the initialised process group on
    one axis named ``"data"``.

    ``num_devices`` defaults to the group's world size and must equal it.
    ``device_type`` is ``"cuda"`` (the collectives run on the card: NCCL,
    or gloo staging CUDA tensors through the host) unless the caller asks
    for ``"cpu"``.  Raises, with the reason, when no process group is
    initialised: the caller gives ``init_process_group`` its address,
    world size and rank.  On an NCCL group one all-reduce warms the
    communicator, so a loop that captures its collectives in CUDA graphs
    finds it built.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError(
            "make_walker_mesh needs an initialised torch.distributed process "
            "group: call init_process_group(backend, init_method=..., "
            "world_size=..., rank=...) first; it does not make a world of one")
    world = dist.get_world_size()
    n = world if num_devices is None else int(num_devices)
    if n != world:
        raise ValueError(f"num_devices={n}, but the process group has "
                         f"{world} ranks; the walker mesh spans them all")
    if device_type not in ("cuda", "cpu"):
        raise ValueError(f"device_type must be 'cuda' or 'cpu', got "
                         f"{device_type!r}")
    if device_type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device_type='cuda' but no CUDA device is "
                           "visible; pass device_type='cpu' for a CPU mesh")
    mesh = init_device_mesh(device_type, (n,), mesh_dim_names=("data",))
    group = mesh.get_group("data")
    if device_type == "cuda" and dist.get_backend(group) == "nccl":
        warm = torch.zeros(1, device=torch.device("cuda",
                                                  torch.cuda.current_device()))
        dist.all_reduce(warm, group=group)
        torch.cuda.synchronize()
    return mesh


@contextlib.contextmanager
def fake_device_mesh(abstract_mesh):
    """A ``DeviceMesh`` of ``abstract_mesh``'s shape and axis names over a
    fake process group of ``prod(shape)`` ranks, this process rank 0; the
    group is destroyed on exit.

    The fake group (``torch.testing._internal.distributed.fake_pg``)
    completes every collective at once without moving data, so a DTensor
    program traced on this mesh (under ``FakeTensorMode``) issues the
    collectives the real mesh would, and ``CommDebugMode`` counts them;
    nothing touches a card.  Raises, with the reason, when a process group
    is already initialised: it is someone else's, and this never tears it
    down.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError(
            "fake_device_mesh needs no process group initialised: one is "
            f"(backend {dist.get_backend()!r}, world size "
            f"{dist.get_world_size()}), and it is not this function's to "
            "destroy")
    shape = tuple(int(d) for d in abstract_mesh.shape)
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=math.prod(shape))
    try:
        yield init_device_mesh("cpu", shape,
                               mesh_dim_names=tuple(abstract_mesh.axis_names))
    finally:
        dist.destroy_process_group()


class HW:
    """One NVIDIA H100 SXM's published figures (NVIDIA's H100 data sheet,
    dense rates at the full 700 W), the roofline's denominators."""

    PEAK_FLOPS_BF16 = 989e12  # FLOP/s, dense bf16 on the tensor cores
    PEAK_FLOPS_FP32 = 67e12  # FLOP/s, float32 outside the tensor cores
    PEAK_FLOPS_TF32 = 495e12  # FLOP/s, dense TF32 on the tensor cores
    HBM_BW = 3.35e12  # bytes/s
    HBM_BYTES = 80e9  # 80 GB of HBM3
    NVLINK_BW = 900e9  # bytes/s per GPU, all NVLink links together
    # bytes/s per GPU between nodes: a DGX H100 gives each GPU one 400 Gb/s
    # ConnectX-7 port (NVIDIA DGX H100 user guide); a collective whose group
    # spans more than NODE_GPUS GPUs is priced at this rate
    INTER_NODE_BW = 50e9
    NODE_GPUS = 8

    @classmethod
    def link_bw(cls, group_size: int) -> float:
        """The per-GPU rate of a collective over ``group_size`` GPUs:
        NVLink inside a node, the network beyond it."""
        return cls.NVLINK_BW if group_size <= cls.NODE_GPUS else cls.INTER_NODE_BW
