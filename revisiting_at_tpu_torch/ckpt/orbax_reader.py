"""Read the params of a JAX run's orbax snapshot without JAX or orbax: a
collection of its TrainState, 'params' or 'ema_params', and for a BN model
'batch_stats' or 'ema_batch_stats' (the running statistics).

The JAX package's CheckpointManager writes each epoch's TrainState with
orbax's StandardSave into <slot>/<epoch>/default/: an OCDBT key-value store
of zarr arrays, one per leaf, and a `_METADATA` JSON file whose
`tree_metadata` maps each leaf's key path, e.g. ('params', 'stem', 'proj',
'Conv_0', 'kernel'), to its metadata. A collection saved as None (a run
without EMA keeps `ema_params` None) has one entry with value_type "None".

Each leaf is read through tensorstore, which does not import JAX (orbax
does): a zarr array in the OCDBT store at file://<snapshot>/default/, under
the key path joined by '.'. tensorstore is imported only when a leaf is
read. Where it is not
installed, the reader raises ImportError: export such a run to a .pt file
on a machine with the JAX package instead.
"""

from __future__ import annotations

import json
import os
from pathlib import Path

import numpy as np

_EXPORT = ("python -m revisiting_at_tpu.cli.export --run_dir <run> --out weights.pt "
           "[--epoch N] [--best] [--use_ema 1]")


def steps(slot: str | Path) -> list[int]:
    """The snapshots of a slot (a run's ckpt/ or ckpt_best/), by epoch:
    the numbered directories that hold a finished default/_METADATA."""
    slot = Path(slot)
    if not slot.is_dir():
        return []
    return sorted(int(n) for n in os.listdir(slot)
                  if n.isdigit() and (slot / n / "default" / "_METADATA").is_file())


def read_params(snapshot: str | Path, collection: str = "params") -> dict | None:
    """The `collection` ('params', 'ema_params', 'batch_stats' or
    'ema_batch_stats') of the snapshot dir <slot>/<epoch> as nested dicts
    of numpy arrays, or None where it was saved as None."""
    base = Path(snapshot).absolute() / "default"
    meta = json.loads((base / "_METADATA").read_text())
    if not meta.get("use_ocdbt", True) or meta.get("use_zarr3", False):
        raise ValueError(f"{base}: only orbax's default layout (OCDBT, zarr v2) is read here; "
                         f"export the run with `{_EXPORT}`")
    leaves = []
    for entry in meta["tree_metadata"].values():
        keys = [k["key"] for k in entry["key_metadata"]]
        if keys[0] != collection:
            continue
        if entry["value_metadata"]["value_type"] == "None":
            return None
        leaves.append(keys[1:])
    if not leaves:
        return None
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(f"reading a JAX run's orbax checkpoint needs the tensorstore package, "
                          f"which is not installed here: export the run on a machine with the "
                          f"JAX package, `{_EXPORT}`, and pass --torch_ckpt weights.pt") from e
    tree: dict = {}
    for keys in leaves:
        spec = {"driver": "zarr", "kvstore": {"driver": "ocdbt", "base": f"file://{base}/",
                                              "path": ".".join([collection, *keys])}}
        node = tree
        for k in keys[:-1]:
            node = node.setdefault(k, {})
        node[keys[-1]] = np.asarray(ts.open(spec).result().read().result())
    return tree
