"""Every random draw of a training step, through one small interface.

The JAX step splits keys (``core/steps.py:183-224``) and no torch
generator reproduces those streams, so the port draws through ``Draws``:
by default from a ``torch.Generator`` on the step's device, and in the
tests from a list of tensors made with ``jax.random`` from the JAX step's
own keys (``ReplayedDraws``).  Each draw has a name, and a replay checks
that the names and shapes come in the order it was recorded in.

The draws of a step, in the order the port makes them (``core/steps.py``):
a generator update samples three fresh batches (``sample_batch``: ``idx``,
then ``crop_x``, ``crop_y`` when the pack is larger than the crop, then
``flip`` when it augments), then the pool ranks (``rank``), the agent
step's dropout masks (``dropout``, when its keep probability is below 1)
and selection noise (``noise``), then the over-length keep mask
(``keep``); a critic update samples the real batch, then the terminated
records (``terminated``) and the interpolation weights (``alpha``).

``Draws(record=True)`` keeps what it drew, so that the same draws can be
replayed on another device (``chip_smoke.py`` holds the card's step to the
CPU's so).
"""

import collections

import torch


class Draws:
    """Draws from ``generator`` (None: torch's global generator for the
    device) on ``device``."""

    def __init__(self, generator=None, device='cpu', record=False):
        self.generator = generator
        self.device = torch.device(device)
        self.log = [] if record else None

    def _kept(self, name, value):
        if self.log is not None:
            self.log.append((name, value))
        return value

    def uniform(self, name, shape):
        """float32 in [0, 1), as ``jax.random.uniform``."""
        return self._kept(name, torch.rand(
            shape, generator=self.generator, device=self.device))

    def randint(self, name, high, shape):
        """int64 in [0, high), as ``jax.random.randint(key, shape, 0,
        high)``."""
        return self._kept(name, torch.randint(
            0, high, shape, generator=self.generator, device=self.device))

    def bernoulli(self, name, p, shape):
        """bool, True with probability ``p``: ``uniform < p``, as
        ``jax.random.bernoulli``."""
        return self._kept(name, torch.rand(
            shape, generator=self.generator, device=self.device) < p)

    def categorical(self, name, logits, n):
        """``n`` indices drawn from ``softmax(logits)`` ([K] logits) by the
        Gumbel-max trick in float32, as ``jax.random.categorical``, with no
        wait on the device.  Where every logit is -1e9 (nothing to draw
        from) the noise is lost in float32 rounding and every draw is slot
        0, as in JAX (whose replay docstring says uniform); unlike
        ``torch.multinomial`` on all-zero weights, it does not raise."""
        u = torch.rand((n, logits.shape[0]), generator=self.generator,
                       device=self.device)
        gumbel = -torch.log(-torch.log(u))
        return self._kept(name, torch.argmax(gumbel + logits, dim=1))


class ReplayedDraws(Draws):
    """Hands out ``log``'s ``(name, tensor)`` pairs in order, moved to
    ``device``; a name or shape other than the next one's raises."""

    def __init__(self, log, device='cpu'):
        super().__init__(device=device)
        self._queue = collections.deque(log)

    def _next(self, name, shape):
        if not self._queue:
            raise ValueError('no draw left for %r %s' % (name, tuple(shape)))
        want, value = self._queue.popleft()
        if want != name or tuple(value.shape) != tuple(shape):
            raise ValueError('draw %r %s asked for, %r %s is next'
                             % (name, tuple(shape), want,
                                tuple(value.shape)))
        return value.to(self.device)

    def uniform(self, name, shape):
        return self._next(name, shape)

    def randint(self, name, high, shape):
        return self._next(name, shape)

    def bernoulli(self, name, p, shape):
        return self._next(name, shape)

    def categorical(self, name, logits, n):
        return self._next(name, (n,))

    def left(self):
        """The number of draws not handed out yet."""
        return len(self._queue)


def uniform(source, name, shape, device):
    """``torch.rand`` from a ``torch.Generator`` (None: the global one), or
    the named draw of a ``Draws``."""
    if isinstance(source, Draws):
        return source.uniform(name, shape)
    return torch.rand(shape, generator=source, device=device)


def randint(source, name, high, shape, device):
    """``torch.randint(0, high)`` from a ``torch.Generator``, or the named
    draw of a ``Draws``."""
    if isinstance(source, Draws):
        return source.randint(name, high, shape)
    return torch.randint(0, high, shape, generator=source, device=device)
