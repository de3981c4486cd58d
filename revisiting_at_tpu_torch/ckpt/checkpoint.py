"""The port's checkpoints of a run, counterpart of
revisiting_at_tpu/ckpt/checkpoint.py: full training state for a true
resume, a best-robust slot, and finding a run's weights for evaluation.

Layout of a run dir (an entry is written at epochs e with
e % save_freq == 0 and at the last, as JAX's manager writes its orbax
snapshots):
  ckpt/weights_<e>.pt      the model in the reference format (timm names, f32)
  ckpt/weights_ema_<e>.pt  the EMA weights in the same format (with model.model_ema;
                           a BN model's with the EMA of its running statistics)
  ckpt/state_<e>.pt        the full state: model state_dict (a BN model's
                           running statistics with it), optimizer (its
                           AdamW/SGD state, update count and any partial
                           gradient accumulation), EMA tensors (the EMA
                           statistics with them), step, epoch, and the
                           trainer's best adversarial accuracy
  ckpt_best/               one entry of the same three files, replaced
                           whenever adversarial validation improves

A JAX run keeps orbax snapshots in ckpt/<e>/ (and ckpt_best/<e>/), which
`restore_run_weights` reads through ckpt/orbax_reader.py.

A run on a mesh (the state's `parallel`, parallel/zero.py) writes the same
files: every rank gathers its FSDP slices and TP shards to whole tensors,
rank 0 alone writes them, and a barrier follows, so the single-process
`cli.eval` and `cli.export` read a distributed run unchanged. A resume
reads the whole state on every rank and cuts it to the rank's layout.
"""

from __future__ import annotations

import os
import re
from pathlib import Path
from typing import TYPE_CHECKING

import torch
import torch.distributed as dist

from . import orbax_reader
from ..models.factory import model_family
from .convert import jax_params_to_state_dict, read_torch_checkpoint, save_torch_checkpoint

if TYPE_CHECKING:
    from ..train.state import TrainState

_ENTRY = re.compile(r"(weights|weights_ema|state)_(\d+)\.pt$")


def _epochs(slot: Path, kind: str) -> list[int]:
    """The epochs of the slot's `kind` files ('weights', 'weights_ema', 'state')."""
    if not slot.is_dir():
        return []
    return sorted(int(m[2]) for m in map(_ENTRY.match, os.listdir(slot))
                  if m is not None and m[1] == kind)


def _atomic(path: Path, write) -> None:
    """write(tmp) and rename tmp to path, so that a run killed while saving
    leaves the previous entry whole and no torn file."""
    tmp = path.with_name(path.name + ".tmp")
    write(tmp)
    os.replace(tmp, path)


def _barrier(state: TrainState) -> None:
    if state.parallel is not None:
        dist.barrier()


def save_entry(slot: Path, epoch: int, state: TrainState, **extra) -> None:
    """Write the entry of `epoch` into `slot`: the weights, the EMA weights
    (when the state keeps an EMA) and the full state with `extra`. On a
    mesh every rank takes part in the gathers and rank 0 writes."""
    model, par = state.model, state.parallel
    if par is None:
        sd, opt, ema = model.state_dict(), state.optimizer.state_dict(), state.ema
    else:
        sd = par.full_state_dict()
        opt = par.full_optimizer_state(state.optimizer)
        ema = None if state.ema is None else par.full_ema(state.ema)
        if par.mesh.rank != 0:
            dist.barrier()
            return
    slot.mkdir(parents=True, exist_ok=True)
    _atomic(slot / f"weights_{epoch}.pt", lambda t: save_torch_checkpoint(model, t, sd=sd))
    if ema is not None:
        _atomic(slot / f"weights_ema_{epoch}.pt",
                lambda t: save_torch_checkpoint(model, t, ema=ema, sd=sd))
    full = {"epoch": epoch, "step": state.step, "model": sd, "optimizer": opt, "ema": ema,
            **extra}
    _atomic(slot / f"state_{epoch}.pt", lambda t: torch.save(full, str(t)))
    _barrier(state)


def load_state(path: Path, state: TrainState) -> dict:
    """Restore the full state at `path` into `state` in place; returns the
    entry's other fields (epoch and the `extra` of save_entry)."""
    device = next(state.model.parameters()).device
    sd = torch.load(str(path), map_location=device, weights_only=True)
    par = state.parallel
    if par is None:
        state.model.load_state_dict(sd.pop("model"))
        state.optimizer.load_state_dict(sd.pop("optimizer"))
    else:
        par.load_full_state_dict(sd.pop("model"))
        par.load_full_optimizer_state(state.optimizer, sd.pop("optimizer"))
    ema = sd.pop("ema")
    if (ema is None) != (state.ema is None):
        raise ValueError(f"{path}: the checkpoint {'has no' if ema is None else 'has an'} EMA "
                         f"and this run's model.model_ema differs: resume with the run's flags")
    if ema is not None:
        if par is not None:
            ema = par.local_ema(ema)
        for name, t in state.ema.items():
            t.copy_(ema[name])
    state.step = sd.pop("step")
    return sd


class CheckpointManager:
    """Epoch cadence and the best slot of one run dir."""

    def __init__(self, run_dir: str | Path, save_freq: int = 1, write: bool = True):
        self.dir = Path(run_dir) / "ckpt"
        self.best_dir = Path(run_dir) / "ckpt_best"
        self.write = write  # rank 0 of a mesh alone writes and removes files
        if write:
            self.dir.mkdir(parents=True, exist_ok=True)
        self.save_freq = save_freq

    def maybe_save(self, epoch: int, state: TrainState, *, last: bool = False, **extra) -> None:
        if epoch % self.save_freq == 0 or last:
            save_entry(self.dir, epoch, state, **extra)

    def save_best(self, epoch: int, state: TrainState, **extra) -> None:
        """Replace the best slot's entry with this epoch's."""
        save_entry(self.best_dir, epoch, state, **extra)
        if not self.write:
            return
        for name in os.listdir(self.best_dir):
            m = _ENTRY.match(name)
            if m is not None and int(m[2]) != epoch:
                (self.best_dir / name).unlink()

    def restore_latest(self, state: TrainState) -> dict | None:
        """Restore the latest full state into `state`; its fields (epoch, ...)
        or None when the run has none."""
        epochs = _epochs(self.dir, "state")
        if not epochs:
            return None
        return load_state(self.dir / f"state_{epochs[-1]}.pt", state)


def restore_run_weights(run_dir: str | Path, arch: str, *, best: bool = False,
                        epoch: int = -1, use_ema: bool = False) -> tuple[dict, int]:
    """(reference-format state_dict, epoch) of a run's checkpoint, the
    port's counterpart of JAX's restore_run_params (checkpoint.py:37-59):
    `best` reads ckpt_best, `epoch` -1 the latest entry. A port run gives
    its weights[_ema]_<e>.pt, a JAX run its orbax snapshot's params or
    ema_params (ckpt/orbax_reader.py), a BN model's with its batch_stats,
    or with use_ema its ema_batch_stats (the statistics JAX's
    TrainState.ema_variables pairs with the EMA weights, state.py:31-36;
    its restore_run_params gives the raw ones, ROADMAP C19). With use_ema
    the run must hold EMA weights: it never falls back to the raw ones."""
    slot = Path(run_dir) / ("ckpt_best" if best else "ckpt")
    no_ema = ValueError("use_ema requested but the run kept no EMA params "
                        "(trained with model.model_ema=0?)")
    port_epochs = _epochs(slot, "weights")
    if port_epochs:
        e = port_epochs[-1] if epoch < 0 else epoch
        if e not in port_epochs:
            raise FileNotFoundError(f"no checkpoint of epoch {e} in {slot} "
                                    f"(it holds epochs {port_epochs})")
        path = slot / f"weights{'_ema' if use_ema else ''}_{e}.pt"
        if use_ema and not path.exists():
            raise no_ema
        return read_torch_checkpoint(path), e
    steps = orbax_reader.steps(slot)
    if not steps:
        raise FileNotFoundError(f"no checkpoint in {slot}")
    e = steps[-1] if epoch < 0 else epoch
    if e not in steps:
        raise FileNotFoundError(f"no checkpoint of epoch {e} in {slot} (it holds {steps})")
    params = orbax_reader.read_params(slot / str(e), "ema_params" if use_ema else "params")
    if params is None:
        if use_ema:
            raise no_ema
        raise ValueError(f"{slot / str(e)}: the snapshot holds no params")
    stats = None
    if model_family(arch) == "resnet":
        stats = orbax_reader.read_params(slot / str(e), "ema_batch_stats") if use_ema else None
        if stats is None:
            stats = orbax_reader.read_params(slot / str(e), "batch_stats")
    return jax_params_to_state_dict(params, arch, stats), e
