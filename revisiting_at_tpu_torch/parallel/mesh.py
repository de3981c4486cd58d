"""Process groups and the mesh, port of revisiting_at_tpu/parallel/mesh.py.

The JAX package lays its devices out as a ("data", "fsdp"[, "model"]) mesh
and lets XLA place the collectives. Here each process drives one device
(torchrun's one process per GPU), the mesh is the same reshape of the
world's ranks, rank = (d * fsdp + f) * model + m, and every axis is a set
of `torch.distributed` subgroups over which the code reduces explicitly:

  * "data" and "fsdp" shard the batch: each process feeds its own shard,
    and the ranks that share a "model" coordinate form the batch group
    (gradients, metrics, BatchNorm statistics and validation counts are
    reduced over it);
  * "fsdp" also shards the parameters that `_fsdp_spec` picks (at least
    2^14 elements, along their largest divisible axis in JAX's layout),
    with their AdamW moments and EMA (parallel/zero.py);
  * "model" splits the block MLPs (parallel/tp.py); its ranks see the same
    batch.

`init_distributed` starts the process group from torchrun's environment
(RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR, MASTER_PORT), or from the
config's dist section where the environment is silent.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

# what a collective may wait before the process group gives up: a rank that
# died or never started fails the others instead of hanging them
DEFAULT_TIMEOUT_S = 600


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    data: int = -1  # -1: all remaining ranks
    fsdp: int = 1
    model: int = 1  # tensor-parallel axis (parallel/tp.py); 1 = absent


@dataclasses.dataclass(frozen=True)
class DistInfo:
    """This process's place in the world: its rank, the world size, its
    local rank on the host and its device. `started` is true where
    `init_distributed` made the process group (the caller destroys it)."""

    rank: int
    world: int
    local_rank: int
    device: torch.device
    started: bool = False


def init_distributed(dist_cfg, device: str | torch.device = "cuda", backend: str | None = None,
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> DistInfo:
    """Start the process group this process belongs to, and return its place.

    The world is WORLD_SIZE (torchrun's), else 1; the rank RANK, the local
    rank LOCAL_RANK, the rendezvous MASTER_ADDR:MASTER_PORT, else
    dist_cfg.address and dist_cfg.port. Nothing is started at world size 1
    without dist_cfg.multihost, nor when a group already exists (its rank
    and size are read). backend: NCCL on the card, gloo on the CPU, unless
    given (two ranks on one card take gloo: NCCL refuses them). On the card
    the device is cuda:LOCAL_RANK and becomes the current device."""
    device = torch.device(device)
    env = os.environ
    local = int(env.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local if device.index is None else device.index)
        torch.cuda.set_device(device)
    if dist.is_initialized():
        return DistInfo(dist.get_rank(), dist.get_world_size(), local, device)
    world = int(env.get("WORLD_SIZE", "1"))
    if world == 1 and not dist_cfg.multihost:
        return DistInfo(0, 1, local, device)
    rank = int(env.get("RANK", "0"))
    addr = env.get("MASTER_ADDR", dist_cfg.address)
    port = env.get("MASTER_PORT", str(dist_cfg.port))
    dist.init_process_group(backend or ("nccl" if device.type == "cuda" else "gloo"),
                            init_method=f"tcp://{addr}:{port}", rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return DistInfo(rank, world, local, device, started=True)


class Mesh:
    """The ("data", "fsdp", "model") layout of the world's ranks, as JAX's
    make_mesh reshapes its devices: `shape`, this rank's coordinates, the
    batch rank d * fsdp + f among the `batch_count` batch shards, and one
    subgroup per axis holding this rank (None where the axis has one rank,
    so no collective runs), plus the batch group (data x fsdp)."""

    # the axes of the rank grid each group spans
    SPANS = {"data": (0,), "fsdp": (1,), "model": (2,), "batch": (0, 1)}

    def __init__(self, data: int, fsdp: int, model: int, rank: int = 0):
        self.shape = {"data": data, "fsdp": fsdp, "model": model}
        self.size = data * fsdp * model
        self.rank = rank
        self.coords = {"data": rank // (fsdp * model), "fsdp": rank // model % fsdp,
                       "model": rank % model}
        self.batch_rank = rank // model
        self.batch_count = data * fsdp
        self.groups: dict[str, dist.ProcessGroup | None] = dict.fromkeys(self.SPANS)
        self._made: list[dist.ProcessGroup] = []
        grid = np.arange(self.size).reshape(data, fsdp, model)
        for name, span in self.SPANS.items():
            rest = [a for a in range(3) if a not in span]
            rows = np.transpose(grid, rest + list(span)).reshape(-1, int(np.prod(
                [grid.shape[a] for a in span])))
            if rows.shape[1] == 1:
                continue
            for ranks in rows.tolist():  # new_group is collective: every rank makes every group
                group = dist.new_group(ranks)
                self._made.append(group)
                if rank in ranks:
                    self.groups[name] = group

    def release(self) -> None:
        """Destroy the subgroups this mesh made (idempotent)."""
        for group in self._made:
            dist.destroy_process_group(group)
        self._made = []
        self.groups = dict.fromkeys(self.groups)


def make_mesh(config: MeshConfig | None = None) -> Mesh:
    """The mesh over the process group's ranks (one rank without a group),
    with JAX's sizes and check: data = world // (fsdp * model) unless given,
    and data * fsdp * model must be the world."""
    config = config or MeshConfig()
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    fsdp = max(config.fsdp, 1)
    model = max(config.model, 1)
    data = config.data if config.data > 0 else world // (fsdp * model)
    if data * fsdp * model != world:
        raise AssertionError(f"mesh {data}x{fsdp}x{model} != {world} devices")
    return Mesh(data, fsdp, model, rank)


def batch_shard(rank: int, world: int, model: int = 1) -> tuple[int, int]:
    """(this rank's batch shard, the number of shards): the ranks of one
    "model" group read the same data."""
    return rank // max(model, 1), world // max(model, 1)


def _fsdp_spec(shape: tuple[int, ...], fsdp_size: int, min_size: int) -> int | None:
    """The axis of a leaf (in JAX's layout) to shard over "fsdp": the
    largest axis that fsdp_size divides, the later one on a tie; None
    (replicate) for a leaf under min_size elements or with no such axis."""
    if fsdp_size <= 1 or int(np.prod(shape)) < min_size:
        return None
    order = sorted(range(len(shape)), key=lambda i: (shape[i], i), reverse=True)
    for ax in order:
        if shape[ax] % fsdp_size == 0 and shape[ax] >= fsdp_size:
            return ax
    return None


def jax_layout(shape: tuple[int, ...]) -> tuple[int, ...]:
    """For each axis of a JAX leaf, the axis of the port's tensor it is: a
    Dense kernel [in, out] is the Linear weight [out, in] transposed, a
    conv kernel [kh, kw, I, O] the Conv2d weight [O, I, kh, kw]; other
    leaves keep their layout (ckpt/convert.py)."""
    if len(shape) == 2:
        return (1, 0)
    if len(shape) == 4:
        return (2, 3, 1, 0)
    return tuple(range(len(shape)))


def fsdp_dim(shape: tuple[int, ...], fsdp_size: int, min_size: int = 2 ** 14) -> int | None:
    """The axis of a port tensor that `_fsdp_spec` shards, read on the
    tensor's JAX layout so that the same axis shards in both packages."""
    perm = jax_layout(tuple(shape))
    ax = _fsdp_spec(tuple(shape[p] for p in perm), fsdp_size, min_size)
    return None if ax is None else perm[ax]
