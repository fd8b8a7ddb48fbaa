"""Production meshes and the H100 constants of the dry run's roofline
(port of ``repro.launch.mesh``).

Single pod: 16 x 16 = 256 GPUs, axes (data, model).
Multi-pod:  2 x 16 x 16 = 512 GPUs, axes (pod, data, model) -- the pod
axis is pure data parallelism across pods.

Meshes are ``torch.distributed`` ``DeviceMesh``es with JAX's shapes and
axis names, over the default process group, which the caller initialises
with the mesh's world size (the dry run uses PyTorch's fake process
group; see ``dryrun.py``).  Functions, so that importing this module
touches no process group.
"""
from __future__ import annotations

from torch.distributed.device_mesh import DeviceMesh, init_device_mesh


def production_shape(multi_pod: bool = False
                     ) -> tuple[tuple[int, ...], tuple[str, ...]]:
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda") -> DeviceMesh:
    shape, axes = production_shape(multi_pod)
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def make_test_mesh(shape=(2, 2), axes=("data", "model"),
                   device_type: str = "cpu") -> DeviceMesh:
    """A small mesh for tests (gloo or fake process groups of
    ``prod(shape)`` ranks)."""
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(axes))


# NVIDIA H100 SXM5 80GB constants of the roofline (per GPU).
# Dense bf16 tensor-core rate, without sparsity: NVIDIA H100 datasheet
# (SXM column), 989 TFLOP/s at the 700 W power limit.
PEAK_FLOPS_BF16 = 989e12
# HBM3 bandwidth: NVIDIA H100 datasheet (SXM column), 3.35 TB/s.
HBM_BW = 3.35e12
# Link rate of the collective term: a 16-wide axis spans two 8-GPU HGX
# nodes, so its rings cross nodes and run at the per-GPU inter-node rate:
# one ConnectX-7 NDR InfiniBand port of 400 Gb/s per GPU (NVIDIA DGX H100
# datasheet: 8 ports per 8 GPUs) = 50 GB/s each way.  NVLink (900 GB/s
# per GPU, H100 datasheet) is faster and does not bound such a ring.
LINK_BW = 50e9
# The pod axis runs over the same InfiniBand fabric (one rail per GPU),
# so cross-pod collectives use LINK_BW too: no separate cross-pod factor.
