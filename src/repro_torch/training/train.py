"""The train step: loss -> gradients -> AdamW (counterpart of
``repro.training.train``), on one device.

The state is the model itself (its parameters are the reference-layout
tree, ``Model.params``) and the optimizer's ``(m, v, step)``; a step
updates both in place and returns its metrics. ``microbatches > 1``
splits the batch along dim 0, sums the float32 gradients of the pieces
and divides the loss and the gradients by their count, as the
reference's scan does. The reference also takes ``ShardingRules``: one
card has no mesh, so the port's step takes none.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Optional, Union

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.model import Model
from repro_torch.models.params import (map_tree, map_tree_with_path,
                                       param_shardings, param_specs,
                                       tree_leaves)
from repro_torch.training.optimizer import (AdamWConfig, OptState,
                                            adamw_init, adamw_update)

Batch = Dict[str, object]


@dataclasses.dataclass
class TrainState:
    model: Model
    opt_state: OptState

    @property
    def params(self):
        """The parameter tree in the reference's layout."""
        return self.model.params

    @classmethod
    def create(cls, cfg: ArchConfig, *,
               device: Optional[Union[str, torch.device]] = None,
               seed: int = 0) -> "TrainState":
        """A model with weights drawn from ``seed`` on ``device`` (the card
        unless the CPU is asked for) and fresh optimizer state."""
        device = resolve_device(device)
        model = Model(cfg, device=device,
                      generator=torch.Generator(device).manual_seed(seed))
        return cls(model=model, opt_state=adamw_init(model.params))


def _microbatches(batch: Batch, n: int):
    """``batch`` cut into ``n`` equal pieces along dim 0."""
    b = len(next(iter(batch.values())))
    if b % n:
        raise ValueError(f"batch {b} does not split into {n} microbatches")
    m = b // n
    return [{k: v[i * m:(i + 1) * m] for k, v in batch.items()}
            for i in range(n)]


def make_train_step(cfg: ArchConfig, opt: AdamWConfig,
                    microbatches: int = 1
                    ) -> Callable[[TrainState, Batch], Dict[str, torch.Tensor]]:
    """Returns ``train_step(state, batch) -> {"loss", "grad_norm"}`` (0-dim
    float32 tensors on the model's device; nothing in the step waits for
    the device), which updates ``state`` in place. A leaf the loss does
    not reach (an encoder's token table) gets a zero gradient, as the
    reference's ``grad`` gives it."""

    def grads_of(model: Model, batch: Batch):
        leaves = [t for _, t in tree_leaves(model.params)]
        loss = model.loss(batch)
        grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        return loss.detach(), [torch.zeros_like(t) if g is None else g
                               for g, t in zip(grads, leaves)]

    def train_step(state: TrainState, batch: Batch
                   ) -> Dict[str, torch.Tensor]:
        model = state.model
        if model.cfg != cfg:
            raise ValueError("the state's model has another config")
        model.requires_grad_(True)
        if microbatches == 1:
            loss, grads = grads_of(model, batch)
        else:
            loss, grads = 0.0, None
            for mb in _microbatches(batch, microbatches):
                l, g = grads_of(model, mb)
                loss = loss + l
                grads = [t.float() for t in g] if grads is None else \
                    [a + b for a, b in zip(grads, g)]
            loss = loss / microbatches
            grads = [g / microbatches for g in grads]
        flat = dict(zip((k for k, _ in tree_leaves(model.params)), grads))
        tree = map_tree_with_path(lambda k, _: flat[k], model.params)
        _, _, gnorm = adamw_update(opt, state.params, tree, state.opt_state)
        return {"loss": loss, "grad_norm": gnorm}

    return train_step


def opt_state_shardings(cfg: ArchConfig, rules):
    """The optimizer state's specs: each moment as its parameter, the step
    replicated."""
    ps = param_shardings(cfg, rules)
    return (ps, ps, ())


def opt_state_sds(cfg: ArchConfig, moment_dtype: str = "float32"):
    """The optimizer state ``(m, v, step)`` on the meta device, the
    moments in ``moment_dtype`` (float32, as :func:`adamw_init` makes
    them; the dry-run takes bf16 for arctic-480b, as the reference's)."""
    dt = getattr(torch, moment_dtype)
    moments = map_tree(lambda s: torch.empty(s.shape, dtype=dt,
                                             device="meta"),
                       param_specs(cfg))
    return (moments, map_tree(torch.empty_like, moments),
            torch.empty((), dtype=torch.int32, device="meta"))
