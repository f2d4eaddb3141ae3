"""Checkpoint / resume of experiment state — port of
``safe_exploration_tpu/runtime/checkpoint.py``.

A runner's state (the model with its buffer, factors and hyperparameters,
the episode index, the metric series, the run's configuration) is written
with ``torch.save`` as a tree of dicts, lists, tuples, tensors and plain
Python values, so ``torch.load(weights_only=True)`` (the default since
torch 2.6, which refuses arbitrary classes) reads it back. A model is
stored as a dict of its fields under a family tag (``"__family__"``: the
class name, e.g. ``GPSSM``, ``McDropoutSSM``) and rebuilt from it on load;
``map_location`` places the tensors. Tensors round-trip exactly, so a
resumed run continues bit for bit.

The JAX package's pickles cannot be read here: they hold ``jax.Array``
leaves and a pickled JAX treedef. Its ``orbax`` backend (sharded arrays
written shard by shard) belongs to the multi-chip tier, which is not
ported (ROADMAP Queue 1, item 13).
"""

from __future__ import annotations

import dataclasses
import os
import warnings
from typing import Any

import torch

__all__ = ["save_checkpoint", "load_checkpoint", "latest_checkpoint",
           "checkpoint_path", "restore"]

_TAG = "__family__"
_SUFFIX = ".pt"


def _families() -> dict:
    """The model classes a checkpoint may hold, by name."""
    from safe_exploration_tpu_torch.models.gp import GP
    from safe_exploration_tpu_torch.models.gp_lanes import LaneGP, LaneGPSSM
    from safe_exploration_tpu_torch.models.nn_ssm import McDropoutSSM
    from safe_exploration_tpu_torch.models.sparse_gp import (
        SparseGP,
        SparseGPSSM,
    )
    from safe_exploration_tpu_torch.models.ssm import GPSSM

    return {c.__name__: c for c in (GP, GPSSM, SparseGP, SparseGPSSM,
                                    LaneGP, LaneGPSSM, McDropoutSSM)}


def _pack(v):
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        if type(v).__name__ not in _families():
            raise TypeError(f"no checkpoint family for {type(v).__name__}")
        return {_TAG: type(v).__name__,
                **{f.name: _pack(getattr(v, f.name))
                   for f in dataclasses.fields(v)}}
    if isinstance(v, torch.Tensor):
        return v.detach()
    if isinstance(v, dict):
        if _TAG in v:
            raise ValueError(f"a state dict may not use the key {_TAG!r}")
        return {k: _pack(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_pack(x) for x in v)
    return v


def _unpack(v, families: dict):
    if isinstance(v, dict):
        fields = {k: _unpack(x, families) for k, x in v.items() if k != _TAG}
        return families[v[_TAG]](**fields) if _TAG in v else fields
    if isinstance(v, (list, tuple)):
        return type(v)(_unpack(x, families) for x in v)
    return v


def checkpoint_path(directory: str, step: int, prefix: str = "ckpt_"
                    ) -> str:
    """``directory/{prefix}{step}.pt``."""
    return os.path.join(directory, f"{prefix}{step}{_SUFFIX}")


def save_checkpoint(path: str, state: Any, *, backend: str = "torch") -> str:
    """Write ``state`` (dicts, lists, tuples, tensors, plain values and the
    port's models) to ``path`` with ``torch.save``; returns ``path``."""
    if backend == "orbax":
        raise NotImplementedError(
            "orbax checkpoints (sharded arrays) belong to the multi-chip "
            "tier, which is not ported yet (ROADMAP Queue 1, item 13)")
    if backend != "torch":
        raise ValueError(f"unknown checkpoint backend {backend!r} (torch)")
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    torch.save(_pack(state), path)
    return path


def load_checkpoint(path: str, *, map_location=None) -> Any:
    """Read a state written by :func:`save_checkpoint`, its tensors on
    ``map_location`` (``None``: where they were saved)."""
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path} is a directory (an orbax checkpoint); the port reads "
            "its own torch.save files only (ROADMAP Queue 1, item 13)")
    blob = torch.load(path, map_location=map_location, weights_only=True)
    return _unpack(blob, _families())


def restore(ckpt_dir: str | None, resume: bool, config: dict | None = None,
            *, map_location=None):
    """The runners' start: with ``resume``, the state of the latest
    checkpoint under ``ckpt_dir`` (None, with a warning, when there is
    none), which raises ``ValueError`` where its stored ``"config"``
    differs from ``config`` (``n_ep`` aside: a run resumes to more
    episodes); without it, None, after removing the checkpoints an
    earlier run left in ``ckpt_dir`` (so ``latest_checkpoint`` finds this
    run's)."""
    if ckpt_dir is None:
        if resume:
            raise ValueError("resume needs the checkpoint directory")
        return None
    if not resume:
        for path in _checkpoints(ckpt_dir).values():
            os.remove(path)
        return None
    path = latest_checkpoint(ckpt_dir)
    if path is None:
        warnings.warn(f"no checkpoint under {ckpt_dir}: the run starts "
                      "from the beginning", stacklevel=2)
        return None
    state = load_checkpoint(path, map_location=map_location)

    def strip(c):
        return None if c is None else {k: v for k, v in c.items()
                                       if k != "n_ep"}

    if strip(state.get("config")) != strip(config):
        raise ValueError(
            f"{path} was written by another configuration: "
            f"{state.get('config')} (this run: {config})")
    return state


def _checkpoints(directory: str, prefix: str = "ckpt_") -> dict:
    """``{step: path}`` of the ``{prefix}{step}.pt`` files in
    ``directory``."""
    if not os.path.isdir(directory):
        return {}
    out = {}
    for name in os.listdir(directory):
        if name.startswith(prefix) and name.endswith(_SUFFIX):
            try:
                out[int(name[len(prefix):-len(_SUFFIX)])] = os.path.join(
                    directory, name)
            except ValueError:
                continue
    return out


def latest_checkpoint(directory: str, prefix: str = "ckpt_") -> str | None:
    """The highest-numbered ``{prefix}{step}.pt`` in ``directory``, or
    None."""
    found = _checkpoints(directory, prefix)
    return found[max(found)] if found else None
