"""Hand-written AdamW with a cosine schedule (counterpart of
``repro.training.optimizer``).

Moments are float32 whatever the parameter's dtype; the update is
computed in float32 and cast back. The parameters, moments and step are
updated in place (the reference returns new trees): the model's layers
read views of the parameters, so in place is what they see.

Decoupled weight decay applies where the reference-layout leaf has two
or more dimensions, as the reference decides it: the norm scales and
biases of the stacked layers (``[n_rep, d]``) are decayed, the final
norm's and the unstacked (remainder, shared) blocks' are not.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from repro_torch.models.params import map_tree, tree_leaves

OptState = Tuple[Any, Any, torch.Tensor]     # (m, v, step)


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


def schedule(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """The learning rate at ``step`` (a tensor), float32: linear warmup
    to ``lr`` over ``warmup_steps``, then a cosine down to ``lr *
    min_lr_ratio`` at ``total_steps``."""
    step = torch.as_tensor(step).float()
    warm = step / max(cfg.warmup_steps, 1)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * 0.5 * \
        (1 + torch.cos(math.pi * prog))
    return cfg.lr * torch.where(step < cfg.warmup_steps, warm, cos)


def adamw_init(params) -> OptState:
    """Zero float32 moments shaped as ``params`` (a tree) and step 0 (an
    int32 tensor), on the parameters' device."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    device = tree_leaves(params)[0][1].device
    return (map_tree(zeros, params), map_tree(zeros, params),
            torch.zeros((), dtype=torch.int32, device=device))


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params, grads, opt_state: OptState
                 ) -> Tuple[Any, OptState, torch.Tensor]:
    """One AdamW step, in place: the gradients (a tree shaped as
    ``params``) clipped to a global norm of ``grad_clip``, bias
    correction at the new step, decoupled decay on leaves of rank >= 2.
    Returns ``(params, opt_state, gnorm)``, the first two the objects
    given (updated), ``gnorm`` the float32 global norm before clipping,
    on the device (nothing here waits for it)."""
    m, v, step = opt_state
    step.add_(1)
    ps, gs = tree_leaves(params), tree_leaves(grads)
    if [k for k, _ in ps] != [k for k, _ in gs]:
        raise ValueError("the gradients' tree differs from the parameters'")
    gnorm = torch.stack([g.float().square().sum() for _, g in gs]).sum() \
        .sqrt()
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-9),
                        max=1.0)
    lr = schedule(cfg, step)
    t = step.float()
    b1c, b2c = 1 - cfg.b1 ** t, 1 - cfg.b2 ** t
    for (_, p), (_, g), (_, m_), (_, v_) in zip(ps, gs, tree_leaves(m),
                                                tree_leaves(v)):
        g = g.float() * scale
        m_.mul_(cfg.b1).add_((1 - cfg.b1) * g)
        v_.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
        delta = (m_ / b1c) / ((v_ / b2c).sqrt() + cfg.eps)
        pf = p.float()
        if p.dim() >= 2:
            delta = delta + cfg.weight_decay * pf
        p.copy_(pf - lr * delta)
    return params, opt_state, gnorm
