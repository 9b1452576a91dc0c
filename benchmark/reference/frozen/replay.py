"""The replay pool on the device (torch counterpart of
``exposure_tpu/core/replay.py``), slot for slot the JAX pool's semantics.

- ``select_generator_batch``: rank the pool at random, finished records
  after every unfinished one, take the first ``batch_size``; the finished
  records ranked before the last one taken are dropped (replaced by fresh
  RAW on reinsert).  With fewer unfinished records than the batch, the
  rest of the batch is fresh RAW with the initial state.
- ``reinsert``: the stepped records go back into their slots;
  over-length trajectories survive with probability
  ``over_length_keep_prob``, otherwise fresh RAW takes the slot.
- ``sample_terminated``: the critic trains on terminated records,
  sampled with replacement.  With none in the pool every logit is -1e9 and
  the draw falls back to slot 0 for the whole batch, as the JAX
  ``jax.random.categorical`` does (its docstring says uniform; the Gumbel
  noise is lost in float32 rounding): ``Draws.categorical`` does not raise
  where ``torch.multinomial`` would, and nothing waits on the device.  The
  trainer warns when a critic phase ran so (``pool_health_warning``).

No operation reads a value back to the host.
"""

import dataclasses
from typing import Optional

import torch

from .ops import STATE_STEP_DIM, STATE_STOPPED_DIM


@dataclasses.dataclass
class PoolState:
    images: torch.Tensor            # [P, S, S, C]
    states: torch.Tensor            # [P, D]
    # paired ground truth for supervised mode; None when unsupervised
    ground_truth: Optional[torch.Tensor] = None

    @classmethod
    def create(cls, images, num_state_dim, ground_truth=None):
        return cls(images=images,
                   states=torch.zeros((images.shape[0], num_state_dim),
                                      dtype=images.dtype,
                                      device=images.device),
                   ground_truth=ground_truth)

    @property
    def size(self):
        return self.images.shape[0]

    def terminated_mask(self):
        return self.states[:, STATE_STOPPED_DIM] > 0

    def average_trajectory(self):
        return torch.mean(self.states[:, STATE_STEP_DIM])

    def to(self, device):
        return PoolState(images=self.images.to(device),
                         states=self.states.to(device),
                         ground_truth=None if self.ground_truth is None
                         else self.ground_truth.to(device))


def _rows(mask, ndim):
    """A [N] mask shaped to broadcast over [N, ...] with ``ndim`` dims."""
    return mask.reshape((-1,) + (1,) * (ndim - 1))


def select_generator_batch(pool: PoolState, draws, batch_size: int,
                           fresh_images, fresh_gt=None):
    """Pick ``batch_size`` unfinished records (dropping the finished ones
    ranked before them), backfilling with fresh RAW when short.  Draws the
    pool ranks (``rank``).

    Returns ``(sel_idx [B] int64, batch_images, batch_states, dropped_mask
    [P] bool, batch_gt or None)``."""
    p = pool.size
    r = draws.uniform('rank', (p,))
    unfinished = ~pool.terminated_mask()
    rank = torch.where(unfinished, r, r + 10.0)
    order = torch.argsort(rank, stable=True)
    sel_idx = order[:batch_size]
    # a one-element index and index_fill_: a 0-d index or a python value
    # stored by index would each wait on the device
    threshold = rank[sel_idx[-1:]]
    dropped = ~unfinished & (r < threshold)
    selected = torch.zeros((p,), dtype=torch.bool, device=r.device) \
        .index_fill_(0, sel_idx, True)
    dropped = dropped & ~selected

    batch_images = pool.images[sel_idx]
    batch_states = pool.states[sel_idx]
    sel_finished = ~unfinished[sel_idx]
    batch_images = torch.where(_rows(sel_finished, batch_images.dim()),
                               fresh_images, batch_images)
    batch_states = torch.where(sel_finished[:, None],
                               torch.zeros_like(batch_states), batch_states)
    batch_gt = None
    if pool.ground_truth is not None:
        batch_gt = pool.ground_truth[sel_idx]
        if fresh_gt is not None:
            batch_gt = torch.where(_rows(sel_finished, batch_gt.dim()),
                                   fresh_gt, batch_gt)
    return sel_idx, batch_images, batch_states, dropped, batch_gt


def reinsert(pool: PoolState, draws, sel_idx, new_images, new_states,
             dropped_mask, fresh_for_batch, fresh_for_pool,
             maximum_trajectory_length, over_length_keep_prob,
             batch_gt=None, fresh_gt_for_batch=None,
             fresh_gt_for_pool=None):
    """Write stepped records back, thinning the over-length ones (the
    ``keep`` draw) and replacing dropped slots with fresh RAW.  In
    supervised mode the ground truth follows its record."""
    b = sel_idx.shape[0]
    keep = (new_states[:, STATE_STEP_DIM] < maximum_trajectory_length) | \
        draws.bernoulli('keep', over_length_keep_prob, (b,))
    rec_images = torch.where(_rows(keep, new_images.dim()), new_images,
                             fresh_for_batch)
    rec_states = torch.where(keep[:, None], new_states,
                             torch.zeros_like(new_states))
    images = pool.images.index_copy(0, sel_idx, rec_images)
    states = pool.states.index_copy(0, sel_idx, rec_states)
    dropped = _rows(dropped_mask, images.dim())
    images = torch.where(dropped, fresh_for_pool, images)
    states = torch.where(dropped_mask[:, None], torch.zeros_like(states),
                         states)
    ground_truth = pool.ground_truth
    if ground_truth is not None:
        rec_gt = torch.where(_rows(keep, batch_gt.dim()), batch_gt,
                             fresh_gt_for_batch)
        ground_truth = ground_truth.index_copy(0, sel_idx, rec_gt)
        ground_truth = torch.where(dropped, fresh_gt_for_pool, ground_truth)
    return PoolState(images=images, states=states, ground_truth=ground_truth)


def sample_terminated(pool: PoolState, draws, batch_size: int):
    """Sample terminated records with replacement for critic training (the
    ``terminated`` draw); returns ``(images, idx)``."""
    logits = torch.where(pool.terminated_mask(), 0.0, -1e9)
    idx = draws.categorical('terminated', logits, batch_size)
    return pool.images[idx], idx
