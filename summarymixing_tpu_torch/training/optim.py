"""The recipes' optimizer — the port of `noam_schedule`,
`warm_and_exp_decay_schedule`, `make_adamw` (here the class `AdamW`, and
`MultiSteps` for its `accum_steps`), `make_two_stage_adam_sgd` (the class
`TwoStageAdamSGD`) and `apply_safe_update` from
`summarymixing_tpu/training/optim.py`, written to give optax's numbers:

- `noam_schedule`: lr(step) = peak · √warmup · min(step^-½, step · warmup^-1.5),
  step clamped at 1, in float32;
- `warm_and_exp_decay_schedule`: a linear warm-up from 0 to lr over
  `warmup_steps`, then lr · decay_factor^frac with frac going from 0 to 1
  at `total_steps`, in float32;
- `AdamW`: optax's `chain(clip_by_global_norm, adamw)`: the gradients
  scaled by max_norm / ‖g‖ when ‖g‖ ≥ max_norm; moments
  μ = (1-β1)·g + β1·μ and ν = (1-β2)·g² + β2·ν; bias corrections at the
  incremented count; u = μ̂ / (√ν̂ + ε) + wd · p, weight decay on every
  parameter; p ← p - lr(count) · u with the schedule read at the count
  BEFORE the increment, as optax's `scale_by_learning_rate` does;
- `MultiSteps`: optax's `MultiSteps(inner, every_k_schedule=k)` with a
  constant k: the micro-batch gradients are averaged (a running mean,
  acc + (g - acc) / (n + 1)); every k-th call the inner optimizer steps on
  the mean (so clipping applies to the mean) and the schedule reads the
  inner count, which only those calls advance; between them the
  parameters are not touched;
- `TwoStageAdamSGD`: clipping, then `AdamW` (without its own clipping) on
  its schedule for optimizer steps < `switch_step`, then optax's
  `sgd(lr, momentum, nesterov=True)`: trace ← g + m·trace, u = g + m·trace
  (or the trace without Nesterov), p ← p - lr·u. The JAX transform feeds
  the SGD branch zero gradients before the switch, so its trace stays zero
  until then; here the SGD branch is not run before the switch, which
  leaves the same zeros. After the switch Adam's state is not advanced (the
  JAX transform advances it and discards its updates: nothing reads it);
- `apply_safe_update`: on a non-finite loss or gradient norm the step is
  skipped, so parameters, moments, counts and the accumulator keep their
  values; the norm it returns is the micro-batch gradient's. Its phases
  are the profiler spans `train.finite_check` (the norm and the host's
  read of the verdict) and `train.optimizer`;
- `synced_update`: the same under data parallelism (`parallel/comm.py`'s
  `GradientSync`): without accumulation the gradients and the loss are
  averaged over the processes in one collective before the step (the
  profiler span `train.sync`), so every process decides the skip and steps
  on the same values; with `MultiSteps`
  each micro step averages only the loss and ORs a non-finite flag, and
  the accumulator is averaged once per optimizer step, before the inner
  step. Under a sharding rule (`shards`, `parallel/sharded.py`) every
  micro step averages the whole gradients, and the optimizer steps this
  process's slices; `MultiSteps` keeps its accumulator as slices and
  clips its inner step by the whole accumulator's norm.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from summarymixing_tpu_torch.training.profiling import span


def noam_schedule(lr_peak: float, warmup_steps: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """SpeechBrain's NoamScheduler, peaking at `lr_peak` at `warmup_steps`."""

    def schedule(step) -> torch.Tensor:
        s = torch.clamp(torch.as_tensor(step, dtype=torch.float32), min=1.0)
        w = torch.tensor(float(warmup_steps), dtype=torch.float32, device=s.device)
        return lr_peak * torch.sqrt(w) * torch.minimum(s ** -0.5, s * w ** -1.5)

    return schedule


def warm_and_exp_decay_schedule(lr: float, warmup_steps: int, total_steps: int,
                                decay_factor: float = 0.05
                                ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Linear warm-up 0 -> lr over `warmup_steps`, then an exponential decay
    reaching lr · decay_factor at `total_steps`."""

    def schedule(step) -> torch.Tensor:
        s = torch.as_tensor(step, dtype=torch.float32)
        w = float(warmup_steps)
        warm = lr * s / max(w, 1.0)
        frac = torch.clamp((s - w) / max(total_steps - w, 1.0), 0.0, 1.0)
        decayed = lr * torch.pow(torch.tensor(decay_factor, dtype=torch.float32,
                                              device=s.device), frac)
        return torch.where(s < w, warm, decayed)

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
        return self.update(params, self.clip(grads, norm), state)

    @torch.no_grad()
    def update(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict) -> Dict:
        """The AdamW update of `params` from already clipped `grads`."""
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


class TwoStageAdamSGD:
    """The JAX `make_two_stage_adam_sgd` without its `accum_steps` (wrap it
    in `MultiSteps`): clip to `max_grad_norm`, then AdamW on
    `adam_schedule` for optimizer steps < `switch_step`, then SGD at
    `sgd_lr` with momentum `sgd_momentum` (Nesterov by default). The state
    is a dict: `count` (optimizer steps taken, a Python int), `adam`
    (`AdamW`'s state) and `trace` (the SGD momentum, zero until the switch)."""

    def __init__(self, adam_schedule: Callable, sgd_lr: float, switch_step: int,
                 weight_decay: float = 0.0, betas=(0.9, 0.98), eps: float = 1e-8,
                 max_grad_norm: Optional[float] = 5.0, sgd_momentum: float = 0.99,
                 sgd_nesterov: bool = True):
        self.adam = AdamW(adam_schedule, weight_decay, betas, eps, max_grad_norm)
        self.sgd_lr = sgd_lr
        self.switch_step = switch_step
        self.momentum = sgd_momentum
        self.nesterov = sgd_nesterov

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"count": 0, "adam": self.adam.init(params),
                "trace": [torch.zeros_like(p) for p in params]}

    def stage(self, state: Dict) -> str:
        """"adam" or "sgd": the stage the next optimizer step takes."""
        return "adam" if state["count"] < self.switch_step else "sgd"

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
             norm: Optional[torch.Tensor] = None) -> Dict:
        """Update `params` in place from `grads`; returns the new state."""
        if norm is None:
            norm = global_norm(grads)
        grads = self.adam.clip(grads, norm)
        if self.stage(state) == "adam":
            return dict(state, count=state["count"] + 1,
                        adam=self.adam.update(params, grads, state["adam"]))
        trace = state["trace"]
        if self.momentum:
            torch._foreach_mul_(trace, self.momentum)
            torch._foreach_add_(trace, grads)
            updates = (torch._foreach_add(grads, torch._foreach_mul(trace, self.momentum))
                       if self.nesterov else [t.clone() for t in trace])
        else:
            updates = [g.clone() for g in grads]
        torch._foreach_mul_(updates, -self.sgd_lr)
        torch._foreach_add_(params, updates)
        return dict(state, count=state["count"] + 1, trace=trace)


def optimizer_stage(optimizer, opt_state: Dict) -> Optional[str]:
    """The two-stage optimizer's stage for its next step ("adam" or "sgd"),
    through a `MultiSteps` wrapper; None for any other optimizer."""
    if isinstance(optimizer, MultiSteps):
        optimizer, opt_state = optimizer.inner, opt_state["inner"]
    return optimizer.stage(opt_state) if isinstance(optimizer, TwoStageAdamSGD) else None


class MultiSteps:
    """optax `MultiSteps(inner, every_k_schedule=every_k)`: gradient
    accumulation over `every_k` micro-batches. The state is a dict:
    `mini_step` (micro-batches in the accumulator), `gradient_step` (inner
    steps taken), `inner` (the inner optimizer's state) and `acc`."""

    def __init__(self, inner, every_k: int):
        if every_k < 1:
            raise ValueError(f"every_k must be at least 1, got {every_k}")
        self.inner = inner
        self.every_k = every_k

    def init(self, params: Sequence[torch.Tensor]) -> Dict:
        return {"mini_step": 0, "gradient_step": 0, "inner": self.inner.init(params),
                "acc": [torch.zeros_like(p) for p in params]}

    @torch.no_grad()
    def step(self, params: List[torch.Tensor], grads: List[torch.Tensor], state: Dict,
             norm: Optional[torch.Tensor] = None, reduce: Optional[Callable] = None,
             whole: Optional[Callable] = None) -> Dict:
        """Add `grads` to the running mean; on every `every_k`-th call step
        the inner optimizer on the mean (its own norm) and empty the
        accumulator. `norm`, the micro-batch norm, is not used. `reduce`,
        given, maps the accumulator to its mean over the processes before
        the inner step (one collective per optimizer step). `whole`, given
        (a sharded trainer's `ShardedParameters.whole_tensors`: `params`
        and `grads` are this process's slices), maps the accumulator to
        the whole tensors, whose norm the inner step clips by."""
        acc, n = state["acc"], state["mini_step"]
        torch._foreach_add_(acc, torch._foreach_div(torch._foreach_sub(grads, acc), float(n + 1)))
        if n < self.every_k - 1:
            return dict(state, mini_step=n + 1, acc=acc)
        mean = acc if reduce is None else reduce(acc)
        inner = self.inner.step(params, mean, state["inner"],
                                None if whole is None else global_norm(whole(mean)))
        return {"mini_step": 0, "gradient_step": state["gradient_step"] + 1, "inner": inner,
                "acc": [torch.zeros_like(a) for a in acc]}


def make_two_stage_adam_sgd(adam_schedule: Callable, sgd_lr: float, switch_step: int,
                            weight_decay: float = 0.0, betas=(0.9, 0.98), eps: float = 1e-8,
                            max_grad_norm: Optional[float] = 5.0, sgd_momentum: float = 0.99,
                            sgd_nesterov: bool = True, accum_steps: int = 1):
    """The JAX `make_two_stage_adam_sgd`: `TwoStageAdamSGD`, wrapped in
    `MultiSteps` when `accum_steps` > 1 (`switch_step` counts optimizer
    steps, after accumulation)."""
    opt = TwoStageAdamSGD(adam_schedule, sgd_lr, switch_step, weight_decay, betas, eps,
                          max_grad_norm, sgd_momentum, sgd_nesterov)
    return MultiSteps(opt, accum_steps) if accum_steps > 1 else opt


def make_optimizer(schedule: Callable, weight_decay: float = 0.0, betas=(0.9, 0.98),
                   eps: float = 1e-9, max_grad_norm: Optional[float] = 5.0,
                   accum_steps: int = 1):
    """The JAX `make_adamw`: `AdamW`, wrapped in `MultiSteps` when
    `accum_steps` > 1."""
    opt = AdamW(schedule, weight_decay, betas, eps, max_grad_norm)
    return MultiSteps(opt, accum_steps) if accum_steps > 1 else opt


def apply_safe_update(optimizer, params: List[torch.Tensor], grads: List[torch.Tensor],
                      opt_state: Dict, loss: torch.Tensor, shards=None):
    """The optimizer (`AdamW` or `MultiSteps`) step with the non-finite
    skip: on a non-finite loss or gradient norm nothing is updated. Returns
    (opt_state, grad_norm, finite). With `shards` (a sharded trainer's
    `ShardedParameters`), `grads` are whole, the norm is theirs, and the
    optimizer steps `params`, the kept slices, on their slices of `grads`
    (`MultiSteps` clipping by the whole accumulator's norm)."""
    with span("train.finite_check"):
        norm = global_norm(grads)
        finite = bool(torch.isfinite(loss) & torch.isfinite(norm))
    if finite:
        with span("train.optimizer"):
            if shards is None:
                opt_state = optimizer.step(params, grads, opt_state, norm)
            elif isinstance(optimizer, MultiSteps):
                opt_state = optimizer.step(params, shards.slices(grads), opt_state, norm,
                                           whole=shards.whole_tensors)
            else:
                opt_state = optimizer.step(params, shards.slices(grads), opt_state, norm)
    return opt_state, norm, finite


def synced_update(optimizer, params: List[torch.Tensor], grads: List[torch.Tensor],
                  opt_state: Dict, loss: torch.Tensor, sync=None, shards=None):
    """`apply_safe_update` under data parallelism (`sync`, a
    `parallel.comm.GradientSync`, or None in one process). Returns
    (opt_state, grad_norm, finite, loss), the loss averaged over the
    processes; the norm is of the averaged gradient, or with `MultiSteps`
    in an unsharded run of this process's micro-batch (its accumulator is
    averaged once per optimizer step). With `shards` every micro-batch's
    gradient is averaged before its slices are taken, as each process
    keeps only its slices of the accumulator."""
    if sync is None:
        return (*apply_safe_update(optimizer, params, grads, opt_state, loss, shards), loss)
    if shards is not None or not isinstance(optimizer, MultiSteps):
        with span("train.sync"):
            grads, loss = sync.mean_(grads, loss)
        return (*apply_safe_update(optimizer, params, grads, opt_state, loss, shards), loss)
    with span("train.finite_check"):
        norm = global_norm(grads)
        loss, all_finite = sync.loss_and_flag(loss, torch.isfinite(norm))
        finite = bool(torch.isfinite(loss) & all_finite)
    if finite:
        with span("train.optimizer"):
            opt_state = optimizer.step(params, grads, opt_state, norm, reduce=sync.mean_list_)
    return opt_state, norm, finite, loss


# the JAX module's name
make_adamw = make_optimizer
