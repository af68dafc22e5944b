"""Production meshes as virtual meshes (the port of
``repro/launch/mesh.py``).

The reference builds its meshes over 512 host platform devices for its
dry-run.  This round the port runs one process on one H100, so a mesh here
is a ``VirtualMesh``: axis names and sizes with no devices behind them.
The sharding rules (``repro_torch.distributed.sharding``) compute each
leaf's spec and per-device shard shape over it; nothing is placed.

Mesh shapes:
  single-pod:  (16, 16)      axes ("data", "model")
  multi-pod:   (2, 16, 16)   axes ("pod", "data", "model")

The "model" axis carries TP / EP / (serving) 2D weight sharding; "data"
carries DP / FSDP / sequence-sharded KV; "pod" is pure data parallelism
over pods.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch


@dataclass(frozen=True)
class VirtualMesh:
    """A mesh of named axes with no devices: ``shape`` maps each axis to
    its size (``jax.sharding.Mesh.shape``), ``axis_sizes`` lists them in
    axis order (``mesh.devices.shape``), ``size`` is the chip count."""
    axis_names: Tuple[str, ...]
    axis_sizes: Tuple[int, ...]

    def __post_init__(self):
        if len(self.axis_names) != len(self.axis_sizes):
            raise ValueError(f"axes {self.axis_names} and sizes "
                             f"{self.axis_sizes} differ in length")

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def make_production_mesh(*, multi_pod: bool = False) -> VirtualMesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return VirtualMesh(axes, shape)


def make_mesh(shape: Tuple[int, ...], axes: Tuple[str, ...]) -> VirtualMesh:
    """Arbitrary mesh (hillclimb sweeps over layouts)."""
    return VirtualMesh(tuple(axes), tuple(shape))


def make_host_mesh(n_model: Optional[int] = None) -> VirtualMesh:
    """A mesh over the GPUs this process sees (one on a machine without
    CUDA): ("data", "model") with ``n_model`` on "model"."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 1
    nm = n_model or 1
    return VirtualMesh(("data", "model"), (n // nm, nm))


def mesh_chips(mesh: VirtualMesh) -> int:
    return mesh.size


# NVIDIA H100 80GB HBM3, 700 W (the SXM part; `nvidia-smi` prints its name
# so), per chip, from NVIDIA's H100 data sheet (dense rates, no sparsity);
# used by the dry-run's roofline terms.
PEAK_FLOPS_BF16 = 989e12        # FLOP/s, bf16 tensor cores
HBM_BW = 3.35e12                # bytes/s, HBM3
NVLINK_BW_PER_LINK = 25e9       # bytes/s per direction of one NVLink 4 link
                                # (18 links: 900 GB/s both ways in all)
