"""Optimizer and learning-rate schedule: Adam with fairseq's inverse_sqrt
warmup and a global-norm clip (counterpart of simulst_tpu/train/optim.py,
where the same chain is optax's clip -> scale_by_adam -> [decay] -> lr).

`Adam.update_` follows optax.scale_by_adam exactly: moments
mu = b1 mu + (1 - b1) g and nu = b2 nu + (1 - b2) g^2, bias correction by
the count of updates made so far (this one included), and eps outside the
square root: u = mu_hat / (sqrt(nu_hat) + eps).  The learning rate of
update number c (from 0) is inverse_sqrt_schedule(cfg)(c), as optax's
scale_by_learning_rate evaluates it.  Parameters and moments update in
place (the JAX package returns new arrays).
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Sequence

import torch


@dataclasses.dataclass(frozen=True)
class OptimConfig:
    lr: float = 1e-3
    warmup_updates: int = 4000
    warmup_init_lr: float = 1e-7
    adam_beta1: float = 0.9
    adam_beta2: float = 0.98
    adam_eps: float = 1e-8
    weight_decay: float = 0.0
    clip_norm: float = 10.0


def inverse_sqrt_schedule(cfg: OptimConfig) -> Callable[[int], float]:
    """fairseq inverse_sqrt: linear warmup from warmup_init_lr to lr, then
    lr * sqrt(warmup_updates / step), steps counted from 1."""
    def schedule(count: int) -> float:
        step = count + 1
        if step < cfg.warmup_updates:
            return cfg.warmup_init_lr + (cfg.lr - cfg.warmup_init_lr) * (
                step / cfg.warmup_updates)
        return cfg.lr * (cfg.warmup_updates ** 0.5) * (step ** -0.5)
    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, fp32, as a 0-d tensor
    (no host synchronisation)."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


def clip_by_global_norm_(grads: List[torch.Tensor], max_norm: float,
                         norm: torch.Tensor) -> None:
    """optax.clip_by_global_norm: g * max_norm / max(norm, max_norm), in
    place, given the norm already computed."""
    scale = max_norm / torch.clamp_min(norm, max_norm)
    torch._foreach_mul_(grads, scale)


class Adam:
    """optax.scale_by_adam (+ add_decayed_weights) followed by the
    learning rate, over a fixed list of parameters."""

    def __init__(self, params: Sequence[torch.Tensor], cfg: OptimConfig):
        self.cfg = cfg
        self.schedule = inverse_sqrt_schedule(cfg)
        self.mu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.count = 0

    @torch.no_grad()
    def update_(self, params: List[torch.Tensor],
                grads: List[torch.Tensor]) -> None:
        cfg = self.cfg
        lr = self.schedule(self.count)
        self.count += 1
        b1, b2 = cfg.adam_beta1, cfg.adam_beta2
        g32 = [g.float() for g in grads]
        torch._foreach_lerp_(self.mu, g32, 1.0 - b1)
        torch._foreach_mul_(self.nu, b2)
        torch._foreach_addcmul_(self.nu, g32, g32, value=1.0 - b2)
        c1 = 1.0 - b1 ** self.count
        c2 = 1.0 - b2 ** self.count
        denom = torch._foreach_div(self.nu, c2)
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, cfg.adam_eps)
        upd = torch._foreach_div(self.mu, c1)
        torch._foreach_div_(upd, denom)
        if cfg.weight_decay > 0:
            torch._foreach_add_(upd, [p.float() for p in params],
                                alpha=cfg.weight_decay)
        for p, u in zip(params, upd):
            p.add_(u.to(p.dtype), alpha=-lr)

    def state_dict(self):
        return {"mu": self.mu, "nu": self.nu, "count": self.count}

    def load_state_dict(self, state) -> None:
        for dst, src in zip(self.mu + self.nu, state["mu"] + state["nu"]):
            dst.copy_(src)
        self.count = int(state["count"])
