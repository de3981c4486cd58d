"""One rank's model on the mesh: the gradient sync of the data axes, the
FSDP shards and the checkpoints' full tensors.

The JAX step under `shard_map` (revisiting_at_tpu/train/train_step.py,
mesh= / state_specs=) is shard-local: each device runs the attack and the
training forward on its batch shard, then averages the gradients, the
loss, the metrics and the BatchNorm statistics over the batch axes. Here
that is `ParallelModel`, with one collective where JAX has one:

  * `sync_grads` after the training backward: one all-reduce of the
    flattened gradients of the whole leaves over the batch group, divided
    by its size (JAX's pmean); for an FSDP leaf a reduce-scatter of its
    gradient over the "fsdp" group, an all-reduce over "data" and the same
    division (JAX's psum_scatter, pmean over data and / fsdp). Explicit
    collectives rather than DistributedDataParallel: the attack runs many
    forwards and backwards per step with every parameter's requires_grad
    off (train_step.attack_grad_mode), which DDP's hooks would have to
    survive, and DDP's broadcast of rank 0's buffers would overwrite the
    BatchNorm statistics that JAX averages. The sync runs once per
    training backward, never inside the attack; JAX reports the norm of the
    averaged gradient at every micro-step of grad_accum, so each micro-step
    syncs its own (the mean of k averaged micro-gradients is JAX's);
  * `average_stats` after the training forward: the BatchNorms' running
    statistics averaged over the batch group, before the EMA takes them;
  * `mean` of the step's metrics over the batch group, `sum` of the
    validation counts.

FSDP is a manual ZeRO sharding with JAX's rule (mesh.fsdp_dim): a leaf of
at least 2^14 elements keeps only this rank's slice along the chosen axis
as the tensor the optimizer updates (`master`), so its AdamW moments and
its EMA are slices too; after an update the slices are all-gathered into
the model's full parameter, which the forward, the attack and the fused
kernels read whole (JAX gathers once for the whole step, train_step.py:
157-158). Tensor-parallel leaves (parallel/tp.py) are the model's own
shards and take no FSDP slice.

The checkpoints keep the single-process format: `full` gathers a tensor
of the master layout (a parameter, an AdamW moment, an EMA entry) to its
whole shape, `local` cuts a whole tensor to this rank's layout.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch import nn

from ..models.layers import bn_stat_names
from .mesh import Mesh, fsdp_dim


def _flat_all_reduce(tensors: list[torch.Tensor], group, divide: int = 1) -> None:
    """Sum the tensors over the group in one flattened all-reduce, in place,
    then divide them by `divide` (no-op for no group: an axis of one rank)."""
    if not tensors or group is None:
        return
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    if divide != 1:
        flat /= divide
    for t, part in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(part.view_as(t))


def _gather(t: torch.Tensor, dim: int, group) -> torch.Tensor:
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts, dim=dim)


class ParallelModel:
    """The model of one rank on `mesh` (of more than one rank), with the
    tensor-parallel dims `tp_dims` already applied (parallel/tp.py)."""

    def __init__(self, model: nn.Module, mesh: Mesh, tp_dims: dict[str, int] | None = None):
        self.model, self.mesh = model, mesh
        self.tp_dims = dict(tp_dims or {})
        fsdp = mesh.shape["fsdp"]
        self.fsdp_dims: dict[str, int] = {}
        self.shards: dict[str, nn.Parameter] = {}
        for name, p in model.named_parameters():
            dim = None if name in self.tp_dims else fsdp_dim(tuple(p.shape), fsdp)
            if dim is not None:
                self.fsdp_dims[name] = dim
                self.shards[name] = nn.Parameter(
                    p.detach().chunk(fsdp, dim)[mesh.coords["fsdp"]].clone())
        self.stat_names = bn_stat_names(model)

    # ------------------------------------------------------------ layout
    def named_master(self) -> list[tuple[str, torch.Tensor]]:
        """(name, tensor the optimizer updates): an FSDP leaf's slice, else
        the model's parameter (a TP leaf's own shard)."""
        return [(n, self.shards.get(n, p)) for n, p in self.model.named_parameters()]

    def full(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A tensor of the master layout of parameter `name` at its whole shape."""
        if name in self.fsdp_dims:
            t = _gather(t, self.fsdp_dims[name], self.mesh.groups["fsdp"])
        if name in self.tp_dims:
            t = _gather(t, self.tp_dims[name], self.mesh.groups["model"])
        return t

    def local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A whole tensor of parameter `name` cut to this rank's master layout."""
        t = self.model_local(name, t)
        if name in self.fsdp_dims:
            t = t.chunk(self.mesh.shape["fsdp"], self.fsdp_dims[name])[self.mesh.coords["fsdp"]]
        return t.contiguous()

    def model_local(self, name: str, t: torch.Tensor) -> torch.Tensor:
        """A whole tensor of parameter `name` cut to the model's layout (TP only)."""
        if name in self.tp_dims:
            t = t.chunk(self.mesh.shape["model"], self.tp_dims[name])[self.mesh.coords["model"]]
        return t.contiguous()

    # -------------------------------------------------------------- step
    def sync_grads(self) -> torch.Tensor:
        """Average the training backward's gradients over the batch group
        into the master tensors' .grad, and return the norm of the averaged
        gradient (JAX's grad_norm: the sum of squares of the sharded leaves
        summed over their axis first)."""
        mesh, n = self.mesh, self.mesh.batch_count
        whole = [p.grad for name, p in self.model.named_parameters()
                 if p.grad is not None and name not in self.fsdp_dims]
        _flat_all_reduce(whole, mesh.groups["batch"], n)
        for name, dim in self.fsdp_dims.items():
            p, shard = self.model.get_parameter(name), self.shards[name]
            if p.grad is None:
                shard.grad = None
                continue
            g = p.grad.movedim(dim, 0).contiguous()
            part = torch.empty((g.shape[0] // mesh.shape["fsdp"],) + g.shape[1:],
                               dtype=g.dtype, device=g.device)
            dist.reduce_scatter_tensor(part, g, group=mesh.groups["fsdp"])
            if mesh.groups["data"] is not None:
                dist.all_reduce(part, group=mesh.groups["data"])
            shard.grad = (part / n).movedim(0, dim).contiguous()
            p.grad = None
        grads = {"whole": [], "model": [], "fsdp": []}
        for name, t in self.named_master():
            if t.grad is not None:
                axis = ("fsdp" if name in self.fsdp_dims else
                        "model" if name in self.tp_dims else "whole")
                grads[axis].append(t.grad)
        dev = next(self.model.parameters()).device
        total = {k: torch.stack(torch._foreach_norm(v)).float().pow(2).sum() if v
                 else torch.zeros((), device=dev) for k, v in grads.items()}
        for axis in ("model", "fsdp"):
            if self.mesh.groups[axis] is not None:
                dist.all_reduce(total[axis], group=self.mesh.groups[axis])
        return torch.sqrt(total["whole"] + total["model"] + total["fsdp"])

    @torch.no_grad()
    def after_update(self) -> None:
        """All-gather the updated FSDP slices into the model's parameters."""
        for name, dim in self.fsdp_dims.items():
            self.model.get_parameter(name).copy_(
                _gather(self.shards[name].detach(), dim, self.mesh.groups["fsdp"]))

    @torch.no_grad()
    def average_stats(self) -> None:
        """The BatchNorms' running statistics averaged over the batch group."""
        buffers = dict(self.model.named_buffers())
        _flat_all_reduce([buffers[n] for n in self.stat_names], self.mesh.groups["batch"],
                         self.mesh.batch_count)

    def mean(self, tensors: list[torch.Tensor]) -> list[torch.Tensor]:
        """Each 0-d tensor averaged over the batch group."""
        out = torch.stack([t.detach().float() for t in tensors])
        if self.mesh.groups["batch"] is not None:
            dist.all_reduce(out, group=self.mesh.groups["batch"])
        return list((out / self.mesh.batch_count).unbind())

    def sum(self, values: list[int]) -> list[int]:
        """Integer counts summed over the batch group."""
        dev = next(self.model.parameters()).device
        out = torch.tensor(values, dtype=torch.float64, device=dev)
        if self.mesh.groups["batch"] is not None:
            dist.all_reduce(out, group=self.mesh.groups["batch"])
        return [int(v) for v in out.tolist()]

    # ------------------------------------------------------- checkpoints
    def full_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state_dict at whole shapes (TP shards gathered; an
        FSDP leaf is whole in the model)."""
        sd = self.model.state_dict()
        return {k: self.full(k, v) if k in self.tp_dims else v for k, v in sd.items()}

    def load_full_state_dict(self, sd: dict[str, torch.Tensor]) -> None:
        """Load a whole state_dict: TP leaves cut to this rank's shard, the
        FSDP slices taken from it."""
        self.model.load_state_dict({k: self.model_local(k, v) for k, v in sd.items()})
        with torch.no_grad():
            for name, shard in self.shards.items():
                shard.copy_(self.local(name, sd[name].to(shard.device)))

    def _map_optimizer(self, sd: dict, names: list[str], fn) -> dict:
        """The optimizer's state_dict with fn(name, tensor) applied to every
        per-parameter tensor (AdamW's moments, SGD's momentum, the
        accumulated gradient); scalars (step counts) unchanged."""
        state = {idx: {k: fn(names[idx], v) if torch.is_tensor(v) and v.dim() > 0 else v
                       for k, v in st.items()}
                 for idx, st in sd["opt"]["state"].items()}
        acc = sd["acc"]
        if acc is not None:
            acc = [fn(n, a) for n, a in zip(names, acc)]
        return {**sd, "opt": {**sd["opt"], "state": state}, "acc": acc}

    def full_optimizer_state(self, optimizer) -> dict:
        return self._map_optimizer(optimizer.state_dict(), optimizer.names, self.full)

    def load_full_optimizer_state(self, optimizer, sd: dict) -> None:
        optimizer.load_state_dict(self._map_optimizer(sd, optimizer.names, self.local))

    def full_ema(self, ema: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: self.full(k, v) for k, v in ema.items()}

    def local_ema(self, ema: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        return {k: self.local(k, v) for k, v in ema.items()}
