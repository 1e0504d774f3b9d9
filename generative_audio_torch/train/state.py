"""The optimizer side of a training step: gradient clip, Adam, EMA, step count.

Port of generative_audio_tpu/train/state.py:34-87. The JAX package keeps a
pytree `TrainState` and an optax chain; here a plain class holds the
`nn.Module`, a `torch.optim` optimizer and the step, and updates them in
place. Two things are written out because PyTorch's own versions are other
functions:
  * the global-norm clip is optax's, g * clip / max(norm, clip);
    `torch.nn.utils.clip_grad_norm_` scales by clip / (norm + 1e-6);
  * the EMA follows the reference's warmup, decay = min(decay0, 1 - 1/step),
    so it is a plain running average until 1/step falls below 1 - decay0.
Nothing here reads a value back from the device.
"""
from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Tuple

import torch
from torch import nn

__all__ = ["TrainState", "make_optimizer", "global_norm",
           "clip_by_global_norm_"]


def global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over all tensors (a 0-d fp32 tensor)."""
    norms = torch._foreach_norm(list(tensors))
    return torch.linalg.vector_norm(torch.stack([n.float() for n in norms]))


def clip_by_global_norm_(grads: List[torch.Tensor],
                         max_norm: float) -> torch.Tensor:
    """Scale `grads` in place by max_norm / max(norm, max_norm), optax's
    clip_by_global_norm; returns the norm before the clip."""
    norm = global_norm(grads)
    scale = max_norm / torch.clamp(norm, min=max_norm)
    torch._foreach_mul_(grads, scale)
    return norm


def make_optimizer(params, learning_rate: float = 1e-3,
                   betas: Tuple[float, float] = (0.9, 0.999),
                   weight_decay: float = 0.0,
                   optimizer: str = "Adam") -> torch.optim.Optimizer:
    """Adam, or AdamW with decoupled weight decay, with optax's eps of 1e-8."""
    if optimizer.lower() == "adamw":
        return torch.optim.AdamW(params, lr=learning_rate, betas=tuple(betas),
                                 eps=1e-8, weight_decay=weight_decay)
    return torch.optim.Adam(params, lr=learning_rate, betas=tuple(betas),
                            eps=1e-8)


class TrainState:
    """Model + optimizer + step (+ an optional EMA copy of the parameters).

    `apply_gradients()` consumes the `.grad` of every parameter: clip by the
    global norm (when clip_norm is set), one optimizer step, the EMA update,
    step += 1, and the gradients are dropped."""

    def __init__(self, model: nn.Module, optimizer: torch.optim.Optimizer,
                 clip_norm: Optional[float] = None, ema_decay: float = 0.0):
        self.model = model
        self.optimizer = optimizer
        self.clip_norm = clip_norm
        self.ema_decay = ema_decay
        self.step = 0
        self.ema_params: Optional[Dict[str, torch.Tensor]] = None
        if ema_decay > 0:
            self.ema_params = {k: p.detach().clone()
                               for k, p in model.named_parameters()}

    def apply_gradients(self) -> None:
        grads = [p.grad for p in self.model.parameters() if p.grad is not None]
        if self.clip_norm is not None and grads:
            clip_by_global_norm_(grads, self.clip_norm)
        self.optimizer.step()
        self.optimizer.zero_grad(set_to_none=True)
        self.step += 1
        if self.ema_params is not None:
            decay = min(self.ema_decay, 1.0 - 1.0 / self.step)
            with torch.no_grad():
                for k, p in self.model.named_parameters():
                    self.ema_params[k].lerp_(p, 1.0 - decay)

    def state_dict(self) -> Dict:
        tree = {"params": self.model.state_dict(),
                "opt_state": self.optimizer.state_dict(), "step": self.step}
        if self.ema_params is not None:
            tree["ema_params"] = self.ema_params
        return tree

    def load_state_dict(self, tree: Dict) -> None:
        self.model.load_state_dict(tree["params"])
        if tree.get("opt_state") is not None:
            self.optimizer.load_state_dict(tree["opt_state"])
        self.step = int(tree["step"])
        if self.ema_params is not None and "ema_params" in tree:
            for k, v in tree["ema_params"].items():
                self.ema_params[k].copy_(v)
