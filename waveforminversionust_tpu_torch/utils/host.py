"""Host transfer helpers (port of ``waveforminversionust_tpu.utils.host``).

``fetch`` brings a tensor (on the card or the CPU) or an array-like to
numpy; complex64 stays complex64. The reference also carries
``ComplexParts`` and ``_split_complex``, which exist because its TPU
runtime cannot fetch complex64 outputs; the port's results are complex64
tensors, so neither is ported (ROADMAP.md, "Not ported, by design").
"""

from __future__ import annotations

import numpy as np
import torch


def fetch(x) -> np.ndarray:
    """A tensor (any device) or array-like as a numpy array, its dtype kept
    (complex64 stays complex64)."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


# the reference's name for the same job
as_numpy_complex = fetch


def fetch_tree(tree):
    """:func:`fetch` mapped over the leaves of nested dicts, lists, tuples
    and NamedTuples (their types kept); ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return type(tree)((k, fetch_tree(v)) for k, v in tree.items())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(fetch_tree(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(fetch_tree(v) for v in tree)
    return fetch(tree)
