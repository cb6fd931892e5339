"""The flagship's optimizer — the port of `noam_schedule`, `make_adamw`
(here the class `AdamW`) and `apply_safe_update` from
`summarymixing_tpu/training/optim.py`, written to give optax's numbers:

- `noam_schedule`: lr(step) = peak · √warmup · min(step^-½, step · warmup^-1.5),
  step clamped at 1, in float32;
- `AdamW`: optax's `chain(clip_by_global_norm, adamw)`: the gradients
  scaled by max_norm / ‖g‖ when ‖g‖ ≥ max_norm; moments
  μ = (1-β1)·g + β1·μ and ν = (1-β2)·g² + β2·ν; bias corrections at the
  incremented count; u = μ̂ / (√ν̂ + ε) + wd · p, weight decay on every
  parameter; p ← p - lr(count) · u with the schedule read at the count
  BEFORE the increment, as optax's `scale_by_learning_rate` does;
- `apply_safe_update`: on a non-finite loss or gradient norm the step is
  skipped, so parameters, moments and count keep their values.

The two-stage Adam -> SGD optimizer, the warm + exponential-decay
schedule and gradient accumulation are still to port (ROADMAP.md).
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch


def noam_schedule(lr_peak: float, warmup_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """SpeechBrain's NoamScheduler, peaking at `lr_peak` at `warmup_steps`."""

    def schedule(step) -> torch.Tensor:
        s = torch.clamp(torch.as_tensor(step, dtype=torch.float32), min=1.0)
        w = torch.tensor(float(warmup_steps), dtype=torch.float32, device=s.device)
        return lr_peak * torch.sqrt(w) * torch.minimum(s ** -0.5, s * w ** -1.5)

    return schedule


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of every element's square, in float32."""
    norms = torch._foreach_norm([t.to(torch.float32) for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))


class AdamW:
    """optax `chain(clip_by_global_norm(max_grad_norm), adamw(schedule, b1,
    b2, eps, weight_decay))` over a list of float32 parameters. The state
    is a dict: `count` (a step count on the parameters' device), `mu`, `nu`."""

    def __init__(self, schedule: Callable, weight_decay: float = 0.0,
                 betas=(0.9, 0.98), eps: float = 1e-9, max_grad_norm: Optional[float] = 5.0):
        self.schedule = schedule
        self.weight_decay = weight_decay
        self.b1, self.b2 = betas
        self.eps = eps
        self.max_grad_norm = max_grad_norm

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"count": torch.zeros((), dtype=torch.int32, device=params[0].device),
                "mu": [torch.zeros_like(p) for p in params],
                "nu": [torch.zeros_like(p) for p in params]}

    def clip(self, grads: List[torch.Tensor], norm: torch.Tensor) -> List[torch.Tensor]:
        """optax's `(g / ‖g‖) · max_norm` where ‖g‖ ≥ max_norm, else g."""
        if not self.max_grad_norm:
            return grads
        clip = norm >= self.max_grad_norm
        one = torch.ones((), dtype=norm.dtype, device=norm.device)
        grads = torch._foreach_div(grads, torch.where(clip, norm, one))
        torch._foreach_mul_(grads, torch.where(clip, one * self.max_grad_norm, one))
        return grads

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
             norm: Optional[torch.Tensor] = None) -> Dict:
        """Update `params` in place from `grads`; returns the new state."""
        if norm is None:
            norm = global_norm(grads)
        grads = self.clip(grads, norm)
        b1, b2 = self.b1, self.b2
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, b1)
        torch._foreach_add_(mu, torch._foreach_mul(grads, 1.0 - b1))
        torch._foreach_mul_(nu, b2)
        torch._foreach_add_(nu, torch._foreach_mul(torch._foreach_mul(grads, grads), 1.0 - b2))
        count = state["count"] + 1
        t = count.to(torch.float32)
        mu_hat = torch._foreach_div(mu, 1.0 - torch.tensor(b1, device=t.device) ** t)
        nu_hat = torch._foreach_div(nu, 1.0 - torch.tensor(b2, device=t.device) ** t)
        torch._foreach_sqrt_(nu_hat)
        torch._foreach_add_(nu_hat, self.eps)
        updates = torch._foreach_div(mu_hat, nu_hat)
        if self.weight_decay:
            torch._foreach_add_(updates, torch._foreach_mul(params, self.weight_decay))
        lr = self.schedule(state["count"]).to(params[0].device)
        torch._foreach_mul_(updates, -lr)
        torch._foreach_add_(params, updates)
        return {"count": count, "mu": mu, "nu": nu}


def apply_safe_update(optimizer: AdamW, params: List[torch.Tensor], grads: List[torch.Tensor],
                      opt_state: Dict, loss: torch.Tensor):
    """The optimizer step with the non-finite skip: on a non-finite loss or
    gradient norm nothing is updated. Returns (opt_state, grad_norm, finite)."""
    norm = global_norm(grads)
    finite = bool(torch.isfinite(loss) & torch.isfinite(norm))
    if finite:
        opt_state = optimizer.step(params, grads, opt_state, norm)
    return opt_state, norm, finite
