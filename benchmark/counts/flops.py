"""FLOPs counted on the reference as it runs: every convolution and matrix
product the dispatcher sees (forward, backward and double backward alike),
by ``torch.utils.flop_counter``'s formulas from the operands' shapes.

``FlopCounterMode`` itself also hooks every module to attribute the counts,
and those hooks refuse ``torch.autograd.grad`` over a network run through
``functional_call`` (the training step's form); this mode keeps only the
count."""

from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry


class Flops(TorchDispatchMode):
    """``with Flops() as f: ...`` then ``f.total``."""

    def __init__(self):
        super().__init__()
        self.total = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.total += int(formula(*args, **kwargs, out_val=out))
        return out
