"""One batch as one program: a body captured as a CUDA graph and replayed
(the torch counterpart of the JAX pipeline's jitted programs,
``exposure_tpu/core/serving.py::_single_jit`` and ``_plan_for``, and of the
evaluator's jitted rollout, ``exposure_tpu/core/evaluator.py:84-87``).

``BatchGraph(body, like, device)`` holds a static input buffer of ``like``'s
shape and dtype and one ``torch.Generator`` on the device.  ``run(x, seed)``
copies ``x`` into the buffer, reseeds the generator and runs ``body(input,
generator)``; it returns the body's outputs, which the next run overwrites
(a caller that keeps them clones them).

On the card the first run runs the body eagerly on a side stream (the
warm-up, which lets cuDNN and cuBLAS set up outside the capture), then
captures it with the generator registered (``CUDAGraph.register_generator_
state``) and replays it; every later run is one replay.  A replay reads the
generator's seed and offset when it starts, so reseeding before it makes it
draw what the eager body draws from a generator seeded alike
(``core/fused.py`` holds training to this).  A capture that fails raises:
nothing falls back to the eager body.  On the CPU the same static-buffer
body runs eagerly, and its outputs are copied into the first run's.

Kernel launches under a graph: a wrapper counts a launch where it records
one in a capture, which runs nothing, and a replay runs every recorded
launch again without calling the wrapper.  Each graph keeps the launches its
capture recorded (``launches``), and the module adds them up in ``RECORDED``
and, once a replay, in ``REPLAYED``: a kernel's executions are its wrapper's
count minus ``RECORDED`` plus ``REPLAYED`` (``executions``).

With tracing on (``utils/trace.py``) a run opens the host ranges
``serve.upload`` (the input's copy), ``serve.capture`` and ``serve.launch``
(the host's call of the replay; the device's work is in the body's
regions).
"""

import collections
import time

import torch

from exposure_tpu_torch.ops.dyn_chain import apply_filter_chain_dynamic
from exposure_tpu_torch.ops.static_chain import apply_filter_chain_static
from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch
from exposure_tpu_torch.utils import trace

# kernel launches the captures recorded, and those the replays ran, by the
# wrapper's name (``switch_chain_bf16``: the bf16 part of ``switch_chain``)
RECORDED = collections.Counter()
REPLAYED = collections.Counter()


def wrapper_counts():
    """The chain kernels' wrapper counts, by name."""
    return {'dyn_chain': apply_filter_chain_dynamic.launches,
            'switch_chain': apply_filter_chain_switch.launches,
            'switch_chain_bf16': apply_filter_chain_switch.launches_bf16,
            'static_chain': apply_filter_chain_static.launches}


def executions(counts):
    """``counts`` (wrapper counts by name) as the kernel executions they
    stand for: less the launches captures recorded, plus those replays
    ran."""
    return {name: n - RECORDED[name] + REPLAYED[name]
            for name, n in counts.items()}


def reset_counts():
    RECORDED.clear()
    REPLAYED.clear()


def _tensors(out):
    return (out,) if torch.is_tensor(out) else tuple(out)


class BatchGraph:
    """``body(input, generator)`` on a static input buffer: a CUDA graph
    replayed on the card, run eagerly on the CPU.  ``body`` returns a
    tensor or a tuple (a ``NamedTuple`` too) of tensors."""

    def __init__(self, body, like, device):
        self.body = body
        self.device = torch.device(device)
        self.input = torch.empty(like.shape, dtype=like.dtype,
                                 device=self.device)
        self.generator = torch.Generator(device=self.device)
        self.graph = None
        self.outputs = None
        self.captures = 0     # graphs captured (on the CPU: outputs made)
        self.replays = 0      # runs
        self.launches = {}    # kernel launches the capture recorded
        self.capture_s = 0.0  # host seconds of the warm-up and capture

    def _seed(self, seed):
        if isinstance(seed, torch.Generator):
            self.generator.set_state(seed.get_state())
        else:
            self.generator.manual_seed(int(seed))

    def _capture(self):
        """Run the body eagerly on a side stream, then capture it with the
        generator registered.  Raises if the capture fails."""
        t0 = time.perf_counter()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self.body(self.input, self.generator)
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self.generator)
        before = wrapper_counts()
        with torch.cuda.graph(graph, stream=side,
                              capture_error_mode='thread_local'):
            outputs = self.body(self.input, self.generator)
        after = wrapper_counts()
        self.launches = {k: after[k] - before[k] for k in after
                         if after[k] != before[k]}
        RECORDED.update(self.launches)
        self.graph, self.outputs = graph, outputs
        self.captures += 1
        self.capture_s = time.perf_counter() - t0

    def run(self, x, seed):
        """The body on ``x`` (copied into the input buffer; any device),
        its draws from ``seed``: an int the generator is seeded with, or a
        ``torch.Generator`` whose state it takes (and which is left where
        the body's draws leave it).  Returns the outputs, which the next
        run overwrites."""
        if x is not self.input:
            with trace.span('serve.upload'):
                self.input.copy_(x)
        if self.device.type == 'cuda':
            if self.graph is None:
                with trace.span('serve.capture'):
                    self._capture()
            self._seed(seed)
            with trace.span('serve.launch'):
                self.graph.replay()
            REPLAYED.update(self.launches)
        else:
            self._seed(seed)
            out = self.body(self.input, self.generator)
            if self.outputs is None:
                self.outputs = out
                self.captures += 1
            else:
                for dst, src in zip(_tensors(self.outputs), _tensors(out)):
                    dst.copy_(src)
        if isinstance(seed, torch.Generator):
            seed.set_state(self.generator.get_state())
        self.replays += 1
        return self.outputs

    def release(self):
        """Free the graph, its pool and the buffers; the counts stay."""
        self.graph = self.outputs = self.input = None


class GraphCache:
    """At most ``limit`` ``BatchGraph``s by key, the least recently run
    released first."""

    def __init__(self, limit):
        self.limit = int(limit)
        self.graphs = collections.OrderedDict()

    def get(self, key, body, like, device):
        graph = self.graphs.pop(key, None)
        if graph is None:
            while len(self.graphs) >= self.limit:
                self.graphs.popitem(last=False)[1].release()
            graph = BatchGraph(body, like, device)
        self.graphs[key] = graph
        return graph

    def release(self):
        for graph in self.graphs.values():
            graph.release()
        self.graphs.clear()

    def report(self):
        """The cached graphs' captures, replays, capture seconds and the
        kernel launches each capture recorded (each replay runs them)."""
        out = {'graphs': len(self.graphs), 'captures': 0, 'replays': 0,
               'capture_s': 0.0, 'launches_per_replay': {}}
        for key, g in self.graphs.items():
            out['captures'] += g.captures
            out['replays'] += g.replays
            out['capture_s'] += g.capture_s
            out['launches_per_replay'][repr(key)] = dict(g.launches)
        return out
