"""Checkpoint and resume of a solver state.

Port of ``sleqp_tpu/checkpoint.py`` (the reference has no checkpointing,
SURVEY.md §5.4).  The whole solver state is a small fixed-shape tree of
tensors, so saving and resuming is exact: a resumed solve continues bit
for bit where it stopped, trust radii, penalty, LP basis, quasi-Newton
memory and step-rule history included.

The tensors are written in field order (``lanes.tree_leaves``) into one
numpy ``.npz`` file as ``arr_0``, ``arr_1``, ..., the reference's fallback
layout; the reference's orbax directory format has no counterpart.
"""

from __future__ import annotations

import numpy as np
import torch

from .lanes import tree_leaves, tree_unflatten


def _npz_path(path: str) -> str:
    return path if path.endswith(".npz") else path + ".npz"


def save_state(state, path: str) -> None:
    """Save a ``SolverState`` (or any tree of tensors) to ``path``, with
    ``.npz`` appended when it is missing."""
    np.savez(_npz_path(path), *[t.detach().cpu().numpy() for t in tree_leaves(state)])


def load_state(template, path: str):
    """Load a state saved by ``save_state``: ``template`` gives the tree,
    and each tensor takes its template's dtype and device."""
    with np.load(_npz_path(path)) as data:
        leaves = [torch.as_tensor(data[f"arr_{i}"]).to(dtype=leaf.dtype, device=leaf.device)
                  for i, leaf in enumerate(tree_leaves(template))]
    return tree_unflatten(template, iter(leaves))
