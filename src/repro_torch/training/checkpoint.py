"""Flat-npz checkpoints of the parameter and optimizer trees
(counterpart of ``repro.training.checkpoint``), in the reference's
format: one ``.npz`` with ``__step__``, ``p/<path>`` for each parameter
and ``o/<path>`` for each optimizer leaf, ``<path>`` the leaf's dict keys
and list or tuple indices joined by ``/`` as ``jax.tree_util`` spells
them (``p/stack/0/attn/wq``, ``o/0/embed/tok`` for the first moment,
``o/2`` for the step). A checkpoint either package writes, the other
reads.

numpy has no bfloat16: a bfloat16 leaf is stored as its 2-byte words
(``|V2``, what ``np.save`` writes for the reference's bfloat16 arrays),
and a ``|V2`` array is read back as bfloat16 words.
"""
from __future__ import annotations

import os
from typing import Any, Tuple

import numpy as np

from repro_torch.models.params import (map_tree_with_path, to_numpy,
                                       to_tensor, tree_leaves)


def save_checkpoint(path: str, params, opt_state=None, step: int = 0):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"__step__": np.asarray(step)}
    for k, v in tree_leaves(params):
        payload[f"p/{k}"] = to_numpy(v)
    if opt_state is not None:
        for k, v in tree_leaves(opt_state):
            payload[f"o/{k}"] = to_numpy(v)
    np.savez(path, **payload)


def _restore(data, template, prefix: str):
    """A tree shaped as ``template`` from the arrays under ``prefix``,
    each leaf in its template leaf's dtype and on its device."""
    def leaf_of(key, leaf):
        arr = data[prefix + key]
        if arr.shape != tuple(leaf.shape):
            raise ValueError(f"{prefix + key}: stored shape {arr.shape}, "
                             f"expected {tuple(leaf.shape)}")
        return to_tensor(arr).to(device=leaf.device, dtype=leaf.dtype)

    return map_tree_with_path(leaf_of, template)


def load_checkpoint(path: str, params_template, opt_template=None
                    ) -> Tuple[Any, Any, int]:
    """``(params, opt_state, step)`` from ``path``: new tensors shaped as
    the templates' leaves (the shapes checked), in their dtypes and on
    their devices. To resume, build the model on them:
    ``TrainState(Model(cfg, params), opt_state)``."""
    data = np.load(path, allow_pickle=False)
    step = int(data["__step__"])
    params = _restore(data, params_template, "p/")
    opt = _restore(data, opt_template, "o/") \
        if opt_template is not None else None
    return params, opt, step
