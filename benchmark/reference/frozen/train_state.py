"""Training state: three parameter trees, three Adam states, the EMA of the
critic's mean logit and the outer-iteration counter (torch counterpart of
``exposure_tpu/core/train_state.py``).

The parameter trees are ``state_dict``s (name -> tensor) of ``PolicyNet``
and the two ``CriticNet``s, applied with ``torch.func.functional_call``, so
a step takes gradients with respect to plain tensors as ``jax.grad`` does.

Adam is written out in optax's order of operations (``scale_by_adam`` then
``scale(-1)``, then the learning rate multiplied in outside the chain, as
``apply_lr_update`` does): ``mu``, ``nu``, the bias corrections, ``mu_hat
/ (sqrt(nu_hat) + 1e-8)``.  Its state is optax's ``count``/``mu``/``nu``,
so it round-trips through the JAX checkpoint (``core/checkpoint.py``).  At
lr 0 the moments still move (the iteration-0 warmup) and the parameters
keep their bits.

The counts stay on the host, which knows them exactly: an update's bias
corrections ``1 - b ** count`` are formed there in float32
(``bias_corrections``) and reach the step as device tensors, so that a
step captured in a CUDA graph reads each replay's own (``core/fused.py``);
the step is the same whether it runs eagerly or replayed.
"""

import dataclasses
import functools
from typing import Any

import torch

from .networks import init_like_flax
from .ops import clip

ADAM_EPS = 1e-8


@dataclasses.dataclass
class AdamState:
    """optax ``ScaleByAdamState``: the update count and both moments."""

    count: int
    mu: dict
    nu: dict

    @classmethod
    def create(cls, params):
        return cls(count=0,
                   mu={k: torch.zeros_like(v) for k, v in params.items()},
                   nu={k: torch.zeros_like(v) for k, v in params.items()})


def _bias_correction(decay, count):
    """``1 - decay**count`` in float32, a 0-d host tensor."""
    return 1 - torch.tensor(decay, dtype=torch.float32) ** count


@functools.lru_cache(maxsize=1 << 14)
def _bias_correction_value(decay, count):
    return float(_bias_correction(decay, count))


def bias_corrections(count, n, b1=0.5, b2=0.9):
    """``[[bc1, bc2]] * n``: the bias corrections of the ``n`` updates that
    follow ``count``, as python floats holding ``_bias_correction``'s
    float32 values."""
    return [[_bias_correction_value(b, count + i) for b in (b1, b2)]
            for i in range(1, n + 1)]


@torch.no_grad()
def apply_lr_update(grads, opt, params, lr, b1=0.5, b2=0.9, bc=None):
    """One Adam step with an externally supplied learning rate; returns
    ``(new_params, new_opt)``.  The moments update at lr 0 too.  ``bc``:
    the update's ``(bc1, bc2)`` as tensors on the parameters' device (the
    steps read them from the schedule's scalars, ``core/steps.py``), or
    None to form them here from the count as 0-d host tensors."""
    count = opt.count + 1
    if bc is None:
        bc1, bc2 = _bias_correction(b1, count), _bias_correction(b2, count)
    else:
        bc1, bc2 = bc
    new_params, mu, nu = {}, {}, {}
    for name, g in grads.items():
        mu[name] = (1 - b1) * g + b1 * opt.mu[name]
        nu[name] = (1 - b2) * (g * g) + b2 * opt.nu[name]
        update = (mu[name] / bc1) / (torch.sqrt(nu[name] / bc2) + ADAM_EPS)
        new_params[name] = params[name] + (update * -1.0) * lr
    return new_params, AdamState(count=count, mu=mu, nu=nu)


def clip_tree(tree, bound):
    """Clamp every leaf to [-bound, bound]: the WGAN weight-clipping
    fallback when the gradient penalty is off (biases too, as in the
    reference)."""
    return {k: clip(v, -bound, bound) for k, v in tree.items()}


@dataclasses.dataclass
class EmaState:
    """Zero-debiased EMA of a scalar (``tf.train.ExponentialMovingAverage``
    with ``zero_debias=True``): ``biased`` a 0-d tensor on the device,
    ``count`` the number of updates."""

    biased: torch.Tensor
    count: int

    @classmethod
    def create(cls, device='cpu'):
        return cls(biased=torch.zeros((), device=device), count=0)

    def update(self, value, decay=0.99):
        return EmaState(biased=self.biased * decay + (1.0 - decay) * value,
                        count=self.count + 1)

    @property
    def value(self):
        if self.count == 0:
            return torch.zeros_like(self.biased)
        # in float32, as JAX computes it
        debias = 1 - torch.tensor(0.99) ** torch.tensor(float(self.count))
        return self.biased / debias


@dataclasses.dataclass
class TrainState:
    gen_params: dict
    val_params: dict
    crit_params: dict
    opt_g: AdamState
    opt_v: AdamState
    opt_c: AdamState
    ema: EmaState
    step: int

    @classmethod
    def create(cls, gen_params, val_params, crit_params):
        device = next(iter(gen_params.values())).device
        return cls(gen_params=gen_params, val_params=val_params,
                   crit_params=crit_params,
                   opt_g=AdamState.create(gen_params),
                   opt_v=AdamState.create(val_params),
                   opt_c=AdamState.create(crit_params),
                   ema=EmaState.create(device), step=0)

    def replace(self, **changes: Any):
        return dataclasses.replace(self, **changes)

    def clone(self):
        """A copy with every tensor cloned (the counts are ints)."""
        return self._mapped(torch.Tensor.clone)

    def to(self, device):
        """A copy with every tensor on ``device``."""
        return self._mapped(lambda v: v.to(device))

    def _mapped(self, move):
        """A copy with ``move`` applied to every tensor."""
        def moved(tree):
            return {k: move(v) for k, v in tree.items()}

        def adam(opt):
            return AdamState(opt.count, moved(opt.mu), moved(opt.nu))

        return self.replace(
            gen_params=moved(self.gen_params),
            val_params=moved(self.val_params),
            crit_params=moved(self.crit_params), opt_g=adam(self.opt_g),
            opt_v=adam(self.opt_v), opt_c=adam(self.opt_c),
            ema=EmaState(move(self.ema.biased), self.ema.count))

    def tensors(self):
        """``{path: tensor}`` of every tensor the state holds (the Adam
        counts and the step are python ints)."""
        out = {}
        for tree in ('gen_params', 'val_params', 'crit_params'):
            out.update(('%s/%s' % (tree, k), v)
                       for k, v in getattr(self, tree).items())
        for opt in ('opt_g', 'opt_v', 'opt_c'):
            adam = getattr(self, opt)
            for moment in ('mu', 'nu'):
                out.update(('%s/%s/%s' % (opt, moment, k), v)
                           for k, v in getattr(adam, moment).items())
        out['ema/biased'] = self.ema.biased
        return out


def module_params(module, device=None):
    """A module's ``state_dict`` as a dict of fresh tensors, detached, on
    ``device``."""
    return {k: v.detach().to(device).clone()
            for k, v in module.state_dict().items()}


def init_train_state(cfg, policy, critic, value, seed=0, device='cpu'):
    """Glorot-initialize the three networks from ``seed`` (policy, critic,
    value, in that order, from one CPU ``torch.Generator``) and wrap their
    parameters, on ``device``, in a fresh ``TrainState``."""
    g = torch.Generator().manual_seed(int(seed))
    for module in (policy, critic, value):
        init_like_flax(module.cpu(), g)
    return TrainState.create(module_params(policy, device),
                             module_params(value, device),
                             module_params(critic, device))
