"""Checkpoint and resume for long inversions (port of
``waveforminversionust_tpu.utils.checkpoint``).

The reference writes the inversion state with orbax. The port writes the
same dict with ``torch.save``: every leaf a CPU tensor (numpy arrays and
scalars are converted on the way in), nested dicts kept, so that
``torch.load(..., weights_only=True)`` reads it back without unpickling
arbitrary objects. A file is written beside its target and renamed over
it, so a run killed mid-write leaves the previous checkpoint whole.
``interop.inversion_state`` carries a state saved by the JAX package over.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _to_tensors(tree):
    """The dict ``tree`` with every leaf a CPU tensor."""
    if isinstance(tree, dict):
        return {k: _to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu()
    return torch.from_numpy(np.array(tree))


def save_state(path: str, state: dict) -> None:
    """Save an inversion-state dict of tensors, arrays and scalars (nested
    dicts allowed) to the file ``path``."""
    path = os.path.abspath(path)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_tensors(state), tmp)
    os.replace(tmp, path)


def load_state(path: str) -> dict:
    """Restore a dict saved by :func:`save_state`, every leaf a CPU
    tensor."""
    return torch.load(os.path.abspath(path), map_location="cpu",
                      weights_only=True)


def make_stage_checkpointer(directory: str):
    """Callback for :func:`..fwi.runner.invert_dataset`: saves velocity and
    stage metadata to ``directory/stage_NNN`` after every continuation
    stage."""
    os.makedirs(directory, exist_ok=True)

    def callback(stage_idx, freq, velocity, stage_metrics):
        save_state(os.path.join(directory, f"stage_{stage_idx:03d}"), {
            "velocity": velocity,
            "frequency": np.asarray(freq, np.float64),
            "stage": np.int32(stage_idx),
        })

    return callback
