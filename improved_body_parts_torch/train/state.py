"""Train state and optimizer (counterpart of
``improved_body_parts_tpu/train/state.py``).

The JAX package chains optax's ``add_decayed_weights(5e-4)`` and
``sgd(schedule, momentum=0.9)`` (reference: train_distributed.py:123-124).
The port runs ``torch.optim.SGD(momentum=0.9, dampening=0,
nesterov=False, weight_decay=5e-4)`` over every parameter, BN scale/bias
and conv biases included, as ``add_decayed_weights`` does.  Both compute
``t <- 0.9 t + (g + wd p)``, ``p <- p - lr t``.

:class:`ScheduledSGD` carries what optax keeps in its state besides the
momentum trace: the schedule's update count, on the device, so the
train step's on-device guard can keep it (optax's ``ScaleByScheduleState``
is kept with the rest of the optimizer state on a dropped step), and a
device table of ``schedule(c)`` to read the lr for count ``c`` from
without a host sync.  Every momentum buffer is filled (zeros for a new
state): torch's SGD treats a parameter without one as on its first step.

SWA (reference: train_distributed_SWA.py:403-435 via torchcontrib) keeps a
running average of the parameters in the state.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch
from torch import nn
from torch.optim.sgd import sgd as sgd_update

from ..config import Config


class ScheduledSGD:
    """``torch.optim.SGD`` (fused, so its update can be skipped on the
    device) + the lr schedule + optax's update count."""

    def __init__(self, params, config: Config, schedule: Callable):
        tr = config.train
        self.params = [p for p in params if p.requires_grad]
        dev = self.params[0].device
        self.sgd = torch.optim.SGD(
            self.params, lr=torch.zeros((), device=dev), momentum=tr.momentum,
            dampening=0.0, nesterov=False, weight_decay=tr.weight_decay,
            fused=True)
        for p in self.params:
            self.sgd.state[p]["momentum_buffer"] = torch.zeros_like(
                p, memory_format=torch.preserve_format)
        self.schedule = schedule
        self.max_grad_norm = tr.max_grad_norm
        #: optax ScaleByScheduleState.count: updates applied so far
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self._lrs = torch.empty(0, dtype=torch.float32, device=dev)

    @property
    def momentum(self):
        return [self.sgd.state[p]["momentum_buffer"] for p in self.params]

    def lr(self, horizon: int) -> torch.Tensor:
        """``schedule(count)`` as a 0-d device tensor; ``horizon`` is an
        upper bound of the count that the host knows (the global step)."""
        if horizon >= self._lrs.numel():
            n = max(2 * self._lrs.numel(), horizon + 1, 1024)
            table = np.asarray(self.schedule(np.arange(n)), np.float32)
            self._lrs = torch.from_numpy(table).to(self.count.device)
        return self._lrs.index_select(0, self.count.view(1)).squeeze(0)

    def update(self, ok: torch.Tensor, horizon: int) -> None:
        """One SGD update with the gradients in ``p.grad``, applied only
        where the device flag ``ok`` holds (the fused kernel skips the
        update of every parameter and momentum buffer when its
        ``found_inf`` is 1), and the count advanced only then."""
        group = self.sgd.param_groups[0]
        lr = group["lr"]
        lr.copy_(self.lr(horizon))
        sgd_update(
            self.params, [p.grad for p in self.params], self.momentum,
            weight_decay=group["weight_decay"], momentum=group["momentum"],
            lr=lr, dampening=group["dampening"], nesterov=group["nesterov"],
            maximize=False, fused=True,
            found_inf=(~ok).to(torch.float32))
        self.count += ok.to(self.count.dtype)


def make_optimizer(model: nn.Module, config: Config, schedule: Callable
                   ) -> ScheduledSGD:
    """SGD(momentum 0.9) + L2 weight decay 5e-4 over every parameter of
    ``model`` + optional global-norm clip (``config.train.max_grad_norm``,
    applied by the train step before the decay, as optax chains it)."""
    return ScheduledSGD(model.parameters(), config, schedule)


@dataclass
class TrainState:
    """The model (parameters and BN running stats), the optimizer (momentum
    and update count), the global step, and the SWA average.  Unlike the
    JAX package's immutable state, the train step updates it in place."""
    model: nn.Module
    optimizer: ScheduledSGD
    step: int = 0
    # SWA running average (None until SWA starts): {param name: tensor}
    swa_params: Optional[Dict[str, torch.Tensor]] = None
    swa_count: Optional[int] = None
    # the global step at which SWA began, the cyclic-LR sawtooth anchor
    swa_start_step: Optional[int] = None
    # the storage of a partitioned state (``parallel.sharded.
    # ShardedState``) while its split leaves are held as chunks; None for
    # a full state
    sharding: Optional[Any] = None


def create_train_state(model: nn.Module, config: Config,
                       optimizer: ScheduledSGD) -> TrainState:
    """A TrainState at step 0 for ``model`` (built with its seeded init by
    ``models.build_model(..., train=True)``)."""
    return TrainState(model=model, optimizer=optimizer, step=0)


def load_carried_state(state: TrainState, carried: Dict) -> TrainState:
    """Load a training state carried across from the JAX package
    (``models.convert.flax_train_state_to_torch``) into ``state``:
    parameters, BN running stats, every momentum buffer, the update count
    and the step."""
    model = state.model
    model.load_state_dict({k: torch.from_numpy(v)
                           for k, v in carried["state_dict"].items()},
                          strict=True)
    names = {p: n for n, p in model.named_parameters()}
    with torch.no_grad():
        for p, buf in zip(state.optimizer.params, state.optimizer.momentum):
            buf.copy_(torch.from_numpy(carried["momentum"][names[p]]))
        state.optimizer.count.fill_(carried["count"])
    state.step = carried["step"]
    return state


def _named_params(state: TrainState) -> Dict[str, torch.Tensor]:
    return dict(state.model.named_parameters())


def start_swa(state: TrainState) -> TrainState:
    """Begin stochastic weight averaging from the current params."""
    state.swa_params = {n: p.detach().clone()
                        for n, p in _named_params(state).items()}
    state.swa_count = 1
    state.swa_start_step = state.step
    return state


def update_swa(state: TrainState) -> TrainState:
    """Running average update (torchcontrib SWA ``update_swa``)."""
    if state.swa_params is None:
        raise ValueError("update_swa: call start_swa first")
    n = float(state.swa_count)
    with torch.no_grad():
        for name, p in _named_params(state).items():
            avg = state.swa_params[name]
            avg.copy_((avg * n + p) / (n + 1.0))
    state.swa_count += 1
    return state


def swap_swa_params(state: TrainState) -> TrainState:
    """Swap the averaged params in for evaluation or checkpointing
    (``swap_swa_sgd``): the model takes the average, the state keeps the
    trained values."""
    if state.swa_params is None:
        raise ValueError("swap_swa_params: call start_swa first")
    with torch.no_grad():
        for name, p in _named_params(state).items():
            trained = p.detach().clone()
            p.copy_(state.swa_params[name])
            state.swa_params[name] = trained
    return state
