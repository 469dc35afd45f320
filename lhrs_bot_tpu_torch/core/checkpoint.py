"""Training checkpoints: save, prune, find the latest, load.

Counterpart of `lhrs_bot_tpu/core/checkpoint.py` in its layout without
orbax (the orbax layout stays JAX-only):

    <directory>/checkpoint_<step>/   written as checkpoint_<step>.tmp, then
                                     renamed
        state.pkl                    {"params": ..., "opt_state": ...}
        client_state.pkl             the trainer's progress and hook states
        meta.json                    {"step": step}
    <directory>/latest.txt           the newest checkpoint's name (an mtime
                                     search stands in when it is missing)

Both pickles hold only dicts, lists, tuples, ints, floats, strings, None
and numpy arrays of standard dtypes (bf16 tensors are widened to float32),
so either package reads them without the other's framework: no torch
object and no class of either package is pickled.

`params` are the JAX package's numpy layout (`{"vit", "pooler", "llama",
["lora"]}`, stacked (in, out) weights), the layout `core/torch_import.py`
reads and `core.convert.params_from_numpy` takes; a trainer's frozen leaves
are written as they were loaded (`core.convert.as_loaded`). A quantized
weight is written as the dict `{QUANTIZED_KEY: 1, "q": codes, "scale":
scale, "bits": bits}` (`train.Trainer.resume` copies the codes and scale
back into its QuantizedTensor). `opt_state` is the port's own layout,
`train.optimizer.TrainOptimizer.state_dict`; optax's state cannot be
unpickled without JAX, so this module does not read it.
"""

from __future__ import annotations

import json
import os
import pickle
import shutil
from typing import Any, Dict, Optional

import torch

from ..ops.quant import QuantizedTensor

QUANTIZED_KEY = "__quantized_tensor__"


def to_host(tree):
    """A nested dict / list / tuple of tensors, arrays and scalars as the
    same structure of numpy arrays and plain Python values (bf16 and
    float16 tensors widened to float32; quantized weights as dicts under
    QUANTIZED_KEY)."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    if isinstance(tree, QuantizedTensor):
        return {QUANTIZED_KEY: 1, "q": to_host(tree.q),
                "scale": to_host(tree.scale), "bits": tree.bits}
    if isinstance(tree, torch.Tensor):
        t = tree.detach()
        if t.dtype in (torch.bfloat16, torch.float16):
            t = t.float()
        return t.cpu().numpy()
    return tree


def _dump(obj, path: str) -> None:
    with open(path, "wb") as fh:
        pickle.dump(obj, fh, protocol=pickle.HIGHEST_PROTOCOL)


def save_checkpoint(directory: str, step: int, params: Any,
                    opt_state: Any = None,
                    client_state: Optional[Dict] = None,
                    max_to_keep: Optional[int] = None) -> str:
    """Write checkpoint_{step}/ under `directory` (replacing one of that
    step), point latest.txt at it and prune to `max_to_keep`. `params`
    and `opt_state` may hold tensors on any device. Returns the path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"checkpoint_{step}")
    tmp = path + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    tree = {"params": to_host(params)}
    if opt_state is not None:
        tree["opt_state"] = to_host(opt_state)
    _dump(tree, os.path.join(tmp, "state.pkl"))
    del tree
    if client_state is not None:
        _dump(to_host(client_state), os.path.join(tmp, "client_state.pkl"))
    with open(os.path.join(tmp, "meta.json"), "w") as fh:
        json.dump({"step": step}, fh)
    if os.path.exists(path):
        shutil.rmtree(path)
    os.rename(tmp, path)
    with open(os.path.join(directory, "latest.txt"), "w") as fh:
        fh.write(os.path.basename(path))
    if max_to_keep:
        prune_checkpoints(directory, max_to_keep)
    return path


def _step_of(name: str) -> Optional[int]:
    tail = name[len("checkpoint_"):]
    return int(tail) if tail.isdigit() else None


def prune_checkpoints(directory: str, max_to_keep: int) -> None:
    """Delete all but the `max_to_keep` checkpoints of highest step (a
    `.tmp` directory left by an interrupted write is not a checkpoint)."""
    ckpts = sorted((d for d in os.listdir(directory)
                    if d.startswith("checkpoint_")
                    and _step_of(d) is not None), key=_step_of)
    for stale in ckpts[:-max_to_keep]:
        shutil.rmtree(os.path.join(directory, stale), ignore_errors=True)


def latest_checkpoint(directory: str) -> Optional[str]:
    """The checkpoint latest.txt names, else the newest checkpoint_* by
    mtime, else None."""
    pointer = os.path.join(directory, "latest.txt")
    if os.path.exists(pointer):
        with open(pointer) as fh:
            name = fh.read().strip()
        path = os.path.join(directory, name)
        if name and os.path.exists(path):
            return path
    if not os.path.isdir(directory):
        return None
    ckpts = [os.path.join(directory, d) for d in os.listdir(directory)
             if d.startswith("checkpoint_") and _step_of(d) is not None]
    return max(ckpts, key=os.path.getmtime) if ckpts else None


def load_checkpoint(path: str) -> Dict[str, Any]:
    """{"params", ["opt_state"], ["client_state"], "step"} of a checkpoint
    directory, as written (numpy leaves, quantized weights as their
    QUANTIZED_KEY dicts)."""
    with open(os.path.join(path, "state.pkl"), "rb") as fh:
        out = dict(pickle.load(fh))
    cs = os.path.join(path, "client_state.pkl")
    if os.path.exists(cs):
        with open(cs, "rb") as fh:
            out["client_state"] = pickle.load(fh)
    with open(os.path.join(path, "meta.json")) as fh:
        out["step"] = json.load(fh)["step"]
    return out
