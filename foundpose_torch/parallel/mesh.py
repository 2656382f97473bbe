"""Device mesh, collectives and representation sharding for the
multi-device step (counterpart of foundpose_tpu/parallel/mesh.py).

The JAX package runs the layer as one `shard_map` program over a `Mesh`.
Here it is SPMD over `torch.distributed`: one process (rank) per device,
every rank running the same code, with explicit collectives on the
sub-groups of a `DeviceMesh` whose axes are named `data`, `bank` and, for
a tensor-parallel ViT, `model`:

- crops are data-parallel over `data`;
- each object's template bank is sharded over `bank` (its template-major
  arrays split along the template axis; codebooks and flat arrays whole);
- the ViT's heads and MLP hidden units are split over `model`
  (parallel/tp_vit.py).

Every collective of the layer goes through `_psum` and `_all_gather`,
which take one code path whatever the backend: NCCL where each rank has
its own card, gloo for the CPU and for several ranks sharing one card
(NCCL refuses two ranks on one device). A collective that fails raises.
"""

from __future__ import annotations

import dataclasses
import math
import os
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DATA_AXIS = "data"
BANK_AXIS = "bank"
MODEL_AXIS = "model"  # tensor-parallel ViT axis (parallel/tp_vit.py)
AXES = (DATA_AXIS, BANK_AXIS, MODEL_AXIS)

_NO_GROUP = (
    "a mesh needs an initialized torch.distributed process group whose size is the "
    "mesh's: launch with `torchrun --nproc-per-node N ...` and call "
    "torch.distributed.init_process_group, or use foundpose_torch.parallel.launch"
)


def default_shape(n: int) -> Tuple[int, int]:
    """(data, bank) for n ranks: the bank axis at most 4 wide (the bank
    fetch is cheap; data parallelism over crops is the primary axis)."""
    bank = next(c for c in (4, 2, 1) if n % c == 0)
    return n // bank, bank


def make_mesh(shape: Optional[Sequence[int]] = None):
    """A (data, bank) DeviceMesh, or (data, bank, model) for a 3-tuple,
    over the initialized process group; its size must be prod(shape).

    The backend decides the mesh's device type: "cuda" under NCCL, "cpu"
    otherwise. Under gloo the mesh's groups reduce CUDA tensors through the
    host whatever the device type, so ranks sharing one card need no
    per-rank device."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(_NO_GROUP)
    n = dist.get_world_size()
    shape = tuple(int(s) for s in shape) if shape else default_shape(n)
    if len(shape) not in (2, 3) or min(shape) < 1:
        raise ValueError(f"mesh shape {shape}: expected (data, bank) or (data, bank, model)")
    if math.prod(shape) != n:
        raise ValueError(f"mesh shape {shape} needs {math.prod(shape)} ranks, the process "
                         f"group has {n}; " + _NO_GROUP)
    device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape, mesh_dim_names=AXES[: len(shape)])


def axis_size(mesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def compute_device(device="cuda") -> torch.device:
    """This rank's device: "cuda" means cuda:{LOCAL_RANK % device_count}
    (ranks beyond the card count share cards); anything else as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", dist.get_rank() if dist.is_initialized() else 0))
        device = torch.device("cuda", local % torch.cuda.device_count())
    return device


def init_from_env(device="cuda") -> None:
    """Initializes the default process group from torchrun's environment
    (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT): NCCL when every local
    rank has a card of its own, else gloo."""
    if "WORLD_SIZE" not in os.environ:
        raise ValueError(_NO_GROUP)
    local_world = int(os.environ.get("LOCAL_WORLD_SIZE", os.environ["WORLD_SIZE"]))
    own_card = torch.device(device).type == "cuda" and torch.cuda.device_count() >= local_world
    if own_card:
        torch.cuda.set_device(compute_device(device))
    dist.init_process_group("nccl" if own_card else "gloo")


def data_slice(mesh, b_global: int) -> slice:
    """This rank's rows of a global batch of b_global crops."""
    n = axis_size(mesh, DATA_AXIS)
    if b_global % n:
        raise ValueError(f"the data axis ({n}) must divide the batch ({b_global})")
    b = b_global // n
    i = mesh.get_local_rank(DATA_AXIS)
    return slice(i * b, (i + 1) * b)


# -- collectives ----------------------------------------------------------------


def _psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sums x over the ranks of `axis`, in place; every rank gets the sum."""
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x


_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _to_bits(x: torch.Tensor) -> torch.Tensor:
    """x's bit patterns as int32 (int64 for 8-byte types), value-exact."""
    bits = x.contiguous().view(_BITS[x.element_size()])
    return bits if x.element_size() == 8 else bits.to(torch.int32)


def _from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    size = torch.empty((), dtype=dtype).element_size()
    return bits.to(_BITS[size]).view(dtype)


def _all_gather(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """[n, *x.shape]: x of every rank of `axis`, in coordinate order.

    One _psum of a zero-filled integer buffer in which each rank writes its
    bit patterns at its own row: exact for every dtype (one rank writes
    each row, so no sum rounds), and one collective that NCCL and gloo
    both reduce on CUDA and CPU tensors."""
    n = axis_size(mesh, axis)
    bits = _to_bits(x)
    buf = bits.new_zeros((n, *bits.shape))
    buf[mesh.get_local_rank(axis)] = bits
    return _from_bits(_psum(buf, mesh, axis), x.dtype)


# -- representation sharding ------------------------------------------------------

_TEMPLATE_MAJOR = ("template_descs", "template_mask", "bank_feats", "bank_vertices", "bank_mask")


def repre_shard(repre, index: int, count: int):
    """Shard `index` of `count` of a representation: the template-major
    arrays (descriptors, template mask, banks) narrowed to its slice of the
    template axis (dim 0, or dim 1 for a stacked multi-object repre), the
    codebook, the flat arrays and the cameras whole. The template count
    must divide evenly (repre.pad_templates)."""
    axis = repre.template_descs.dim() - 2
    t = repre.template_descs.shape[axis]
    if t % count:
        raise ValueError(f"{t} templates do not split over {count} bank shards: "
                         "pad them first (repre.pad_templates)")
    tmask = repre.template_mask
    if tmask is None:
        tmask = torch.ones(repre.template_descs.shape[: axis + 1], dtype=torch.bool,
                           device=repre.template_descs.device)
    local = t // count
    arrays = {name: getattr(repre, name) for name in _TEMPLATE_MAJOR}
    arrays["template_mask"] = tmask
    return dataclasses.replace(repre, **{
        name: a.narrow(axis, index * local, local).contiguous() for name, a in arrays.items()
    })


def shard_repre(repre, mesh):
    """This rank's bank shard of a single-object repre ([T, ...] arrays)."""
    if repre.template_descs.dim() != 2:
        raise ValueError("shard_repre takes a single-object [T, ...] repre")
    return repre_shard(repre, mesh.get_local_rank(BANK_AXIS), axis_size(mesh, BANK_AXIS))


def shard_repre_multi(multi_repre, mesh):
    """This rank's bank shard of a stacked multi-object repre
    (repre.stack_repres): the template axis is dim 1."""
    if multi_repre.template_descs.dim() != 3:
        raise ValueError("shard_repre_multi takes a stacked [O, T, ...] repre")
    return repre_shard(multi_repre, mesh.get_local_rank(BANK_AXIS), axis_size(mesh, BANK_AXIS))
