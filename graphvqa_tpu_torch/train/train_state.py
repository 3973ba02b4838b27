"""Train state: the model (parameters and BatchNorm statistics), Adam with
StepLR, and the step and epoch counters (port of
``graphvqa_tpu/train/train_state.py``).

The update is optax's chain as the JAX package builds it, written out:
optional global-norm clipping, then Adam (b1 0.9, b2 0.999, eps 1e-8, bias
corrected), then *decoupled* weight decay (``+ wd * param``), then the
update scaled by -lr, with lr = base * gamma^floor(epoch / lr_drop) (StepLR
stepped per epoch). Every parameter steps, including those that got no
gradient (a zero gradient, as JAX gives them): ``torch.optim.Adam`` would
skip those and apply L2 rather than decoupled decay. Parameters and moments
are float32 and update in place.

The update reads nothing back to the host, so a CUDA graph can hold it:
Adam's count is an int32 scalar on the parameters' device, the bias
corrections ``1 - b**count`` are computed there in float32 (as optax
computes them), and the learning rate is a float32 scalar there too, which
:meth:`TrainState.prepare` refills (``fill_``, outside any graph) when the
epoch has moved. :meth:`TrainState.update` is the device part of a step;
:meth:`TrainState.apply_gradients` is ``prepare``, ``update`` and the host's
step count.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch
from torch import nn

B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def step_lr(base_lr: float, lr_drop: int, gamma: float, epoch: int) -> float:
    """lr = base * gamma^floor(epoch / lr_drop) (torch StepLR semantics)."""
    return base_lr * gamma ** (int(epoch) // lr_drop)


@dataclasses.dataclass
class TrainState:
    """``model`` holds the parameters and the BatchNorm running statistics;
    ``opt_state`` is {"count", "mu", "nu"} with one moment per parameter
    name."""
    model: nn.Module
    opt_state: Dict
    step: int = 0
    epoch: int = 0
    base_lr: float = 1e-4
    lr_drop: int = 90
    lr_gamma: float = 0.1
    weight_decay: float = 0.0
    clip_grad: float = 0.0
    # the learning rate on the device, and the epoch it was filled for
    lr_tensor: Optional[torch.Tensor] = dataclasses.field(default=None,
                                                          repr=False)
    lr_epoch: Optional[int] = dataclasses.field(default=None, repr=False)

    @property
    def params(self) -> Dict[str, torch.Tensor]:
        return dict(self.model.named_parameters())

    @property
    def batch_stats(self) -> Dict[str, torch.Tensor]:
        """The persistent buffers (BatchNorm running statistics)."""
        names = set(self.params)
        return {k: v for k, v in self.model.state_dict().items()
                if k not in names}

    def current_lr(self) -> float:
        return step_lr(self.base_lr, self.lr_drop, self.lr_gamma, self.epoch)

    def prepare(self) -> "TrainState":
        """The host's part before a step, never inside a CUDA graph: Adam's
        count as an int32 tensor on the parameters' device (checkpoints
        written before it moved there hold a Python int) and the device
        learning rate refilled when the epoch has moved since it was last
        filled."""
        dev = next(self.model.parameters()).device
        if not isinstance(self.opt_state["count"], torch.Tensor):
            self.opt_state["count"] = torch.tensor(
                self.opt_state["count"], dtype=torch.int32, device=dev)
        if self.lr_tensor is None:
            self.lr_tensor = torch.empty((), dtype=torch.float32,
                                         device=dev)
        if self.lr_epoch != self.epoch:
            self.lr_tensor.fill_(self.current_lr())
            self.lr_epoch = self.epoch
        return self

    @torch.no_grad()
    def update(self, grads: Dict[str, Optional[torch.Tensor]]) -> None:
        """One optimizer step from ``grads`` (parameter name -> gradient or
        None for zero), in place and on the device only: no value comes
        back to the host and no host value is baked in but the constants.
        Needs :meth:`prepare` first."""
        names, params = zip(*self.model.named_parameters())
        gs = [torch.zeros_like(p) if grads.get(n) is None else grads[n]
              for n, p in zip(names, params)]
        if self.clip_grad:
            norm = torch.linalg.vector_norm(
                torch.stack(torch._foreach_norm(gs)))
            keep = norm < self.clip_grad
            gs = [torch.where(keep, g, (g / norm) * self.clip_grad)
                  for g in gs]
        mu = [self.opt_state["mu"][n] for n in names]
        nu = [self.opt_state["nu"][n] for n in names]
        torch._foreach_mul_(mu, B1)
        torch._foreach_add_(mu, gs, alpha=1.0 - B1)
        torch._foreach_mul_(nu, B2)
        torch._foreach_addcmul_(nu, gs, gs, value=1.0 - B2)
        count = self.opt_state["count"]
        count.add_(1)
        exponent = count.float()
        mu_hat = torch._foreach_div(mu, 1.0 - torch.pow(B1, exponent))
        denom = torch._foreach_div(nu, 1.0 - torch.pow(B2, exponent))
        torch._foreach_sqrt_(denom)
        torch._foreach_add_(denom, ADAM_EPS)
        update = torch._foreach_div(mu_hat, denom)
        if self.weight_decay:
            torch._foreach_add_(update, list(params), alpha=self.weight_decay)
        torch._foreach_mul_(update, self.lr_tensor)
        torch._foreach_sub_(list(params), update)

    def apply_gradients(self, grads: Dict[str, Optional[torch.Tensor]]
                        ) -> "TrainState":
        """One optimizer step from ``grads`` in place; returns ``self``."""
        self.prepare().update(grads)
        self.step += 1
        return self

    def next_epoch(self) -> "TrainState":
        """The next epoch; the device learning rate follows at the next
        :meth:`prepare`."""
        self.epoch += 1
        return self


def create_train_state(model: nn.Module, lr: float = 1e-4, lr_drop: int = 90,
                       lr_gamma: float = 0.1, weight_decay: float = 0.0,
                       clip_grad: float = 0.0) -> TrainState:
    """A fresh state around ``model``: zero moments beside each parameter,
    step and epoch 0."""
    dev = next(model.parameters()).device
    opt_state = {
        "count": torch.zeros((), dtype=torch.int32, device=dev),
        "mu": {n: torch.zeros_like(p) for n, p in model.named_parameters()},
        "nu": {n: torch.zeros_like(p) for n, p in model.named_parameters()}}
    return TrainState(model=model, opt_state=opt_state, base_lr=lr,
                      lr_drop=lr_drop, lr_gamma=lr_gamma,
                      weight_decay=weight_decay, clip_grad=clip_grad)
