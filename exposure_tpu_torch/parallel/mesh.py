"""The data-parallel mesh: ranks, one process a GPU (torch counterpart of
``exposure_tpu/parallel/mesh.py``).

The JAX package runs one process over a 1-D ``jax.sharding.Mesh`` and
reduces with ``lax.pmean`` inside ``shard_map``.  Here each rank is a
process with its own device, joined to the others by a
``torch.distributed`` process group; the strategy is the same pure data
parallelism:

- the replay pool, the dataset packs and every batch axis are split by
  rank (rank r holds rows ``[r * N / w, (r + 1) * N / w)``, as
  ``P(DATA_AXIS)`` places them);
- parameters and optimizer state are replicated;
- gradients and metrics are averaged by ``Mesh.pmean``: an all-reduce SUM
  of one flat buffer, divided by the world size (``gloo`` has no AVG, and
  SUM then divide is what ``lax.pmean`` does).  Under ``nccl`` it is
  captured in the fused step's CUDA graph (``core/fused.py``); ``gloo`` on
  CUDA tensors goes through the host and cannot be
  (``Mesh.check_capturable``).

A world of one needs no process group, and its ``pmean`` is the identity.
``nccl`` is the default backend on the card and ``gloo`` on the CPU; two
ranks on one card take ``gloo`` (over CUDA tensors), which must be asked
for: ``nccl`` refuses them.
"""

import datetime
import hashlib
import os

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = 'data'
RENDEZVOUS_TIMEOUT_S = 60


class Mesh:
    """A rank's view of the data-parallel world: ``rank``, ``world``,
    ``device``, ``backend`` (None for a world of one without a group) and
    the collectives the training step and the trainer use."""

    def __init__(self, rank, world, device, backend, owner=False):
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.owner = owner      # whether this mesh formed the group

    @property
    def shape(self):
        """``{DATA_AXIS: world}``, as the JAX mesh's ``shape``."""
        return {DATA_AXIS: self.world}

    @property
    def grouped(self):
        return self.backend is not None

    def pmean(self, flat):
        """The mean over ranks of a flat float tensor: all-reduce SUM, then
        divide by the world size.  Without a group, ``flat`` itself."""
        if not self.grouped:
            return flat
        dist.all_reduce(flat, op=dist.ReduceOp.SUM)
        return flat / self.world

    def check_capturable(self):
        """Raise ``ValueError`` unless ``pmean`` can be captured in a CUDA
        graph on this rank's device: ``nccl``'s all-reduce runs on the
        card, ``gloo``'s goes through the host on CUDA tensors (on the CPU
        nothing is captured, and any backend serves)."""
        if self.device.type == 'cuda' and self.grouped and \
                self.backend != 'nccl':
            raise ValueError(
                'a %s group cannot be captured in a CUDA graph (its '
                'all-reduce of CUDA tensors goes through the host): set '
                'iters_per_dispatch to 1, or train over nccl' % self.backend)

    def _host_side(self, x):
        """``gloo`` gathers host tensors only."""
        return x.cpu() if self.backend == 'gloo' else x.to(self.device)

    def all_gather(self, x):
        """``[world, *x.shape]``: every rank's ``x``, on ``x``'s device."""
        if not self.grouped:
            return x[None]
        src = self._host_side(x.contiguous())
        out = [torch.empty_like(src) for _ in range(self.world)]
        dist.all_gather(out, src)
        return torch.stack(out).to(x.device)

    def gather_rows(self, x):
        """Rank 0: every rank's ``x`` concatenated along axis 0 in rank
        order (the global array of a ``P(DATA_AXIS)`` shard); other ranks:
        None."""
        if not self.grouped:
            return x
        src = self._host_side(x.contiguous())
        out = [torch.empty_like(src) for _ in range(self.world)] \
            if self.rank == 0 else None
        dist.gather(src, out, dst=0)
        return torch.cat(out).to(x.device) if self.rank == 0 else None

    def all_equal(self, digest):
        """Whether every rank handed in the same digest (bytes)."""
        if not self.grouped:
            return True
        digests = [None] * self.world
        dist.all_gather_object(digests, digest)
        return all(d == digests[0] for d in digests)

    def all_true(self, flag):
        """Whether ``flag`` holds on every rank."""
        if not self.grouped:
            return bool(flag)
        t = torch.tensor([0.0 if flag else 1.0], device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.SUM)
        return float(t) == 0.0

    def barrier(self):
        if not self.grouped:
            return
        if self.backend == 'nccl':
            dist.barrier(device_ids=[self.device.index])
        else:
            dist.barrier()

    def shard(self, x, axis=0):
        """This rank's contiguous ``1 / world`` of ``x`` along ``axis``."""
        n = x.shape[axis]
        if n % self.world:
            raise ValueError('%d rows along axis %d do not split over %d '
                             'ranks' % (n, axis, self.world))
        step = n // self.world
        index = [slice(None)] * x.ndim
        index[axis] = slice(self.rank * step, (self.rank + 1) * step)
        return x[tuple(index)]

    def close(self):
        """Leave the process group, when this mesh formed it."""
        if self.owner and dist.is_initialized():
            dist.destroy_process_group()
        self.owner = False


def digest(*arrays):
    """A sha256 digest of numpy arrays or tensors (dtype, shape, bytes)."""
    h = hashlib.sha256()
    for a in arrays:
        if torch.is_tensor(a):
            a = a.detach().cpu().numpy()
        a = np.ascontiguousarray(a)
        h.update(str((a.dtype, a.shape)).encode())
        h.update(a.tobytes())
    return h.digest()


def _rank_device(device, local_rank):
    device = torch.device(device)
    if device.type != 'cuda' or device.index is not None:
        return device
    return torch.device('cuda', local_rank % max(torch.cuda.device_count(),
                                                 1))


def data_parallel_mesh(num_devices=None, backend=None, device='cuda',
                       rank=None, init_file=None,
                       timeout_s=RENDEZVOUS_TIMEOUT_S):
    """This process's rank of a data-parallel world of ``num_devices``.

    - A process group already formed: its rank and size (``num_devices``,
      when given, must be that size).
    - ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
      ``LOCAL_RANK``): joins the group it names.
    - ``rank`` and ``init_file``: joins a world of ``num_devices`` by a
      ``file://`` rendezvous (a path no other world uses).
    - Otherwise a world of one without a group; more than one device then
      raises.

    ``device``: ``cuda`` (the card of the local rank) or ``cpu``.
    ``backend``: ``nccl`` by default on the card, ``gloo`` on the CPU.
    A group that does not form within ``timeout_s`` raises."""
    if dist.is_available() and dist.is_initialized():
        world, r = dist.get_world_size(), dist.get_rank()
        if num_devices is not None and num_devices != world:
            raise ValueError('a world of %d asked for, the process group '
                             'holds %d' % (num_devices, world))
        local = int(os.environ.get('LOCAL_RANK', r))
        return Mesh(r, world, _rank_device(device, local),
                    dist.get_backend())
    env = 'WORLD_SIZE' in os.environ and 'RANK' in os.environ
    if not env and rank is None:
        if num_devices not in (None, 1):
            raise ValueError(
                'a world of %d needs a process group: run under torchrun, '
                'or pass rank and init_file' % num_devices)
        return Mesh(0, 1, _rank_device(device, 0), None)
    if env:
        world, r = int(os.environ['WORLD_SIZE']), int(os.environ['RANK'])
        local = int(os.environ.get('LOCAL_RANK', r))
        local_world = int(os.environ.get('LOCAL_WORLD_SIZE', world))
        if num_devices is not None and num_devices != world:
            raise ValueError('a world of %d asked for, torchrun started %d'
                             % (num_devices, world))
        init_method = 'env://'
    else:
        if init_file is None or num_devices is None:
            raise ValueError('rank needs init_file and num_devices')
        world, r, local, local_world = int(num_devices), int(rank), \
            int(rank), int(num_devices)
        init_method = 'file://' + os.path.abspath(init_file)
    dev = _rank_device(device, local)
    if backend is None:
        backend = 'nccl' if dev.type == 'cuda' else 'gloo'
    if backend == 'nccl':
        if dev.type != 'cuda':
            raise ValueError('nccl needs CUDA devices, got %s' % dev)
        cards = torch.cuda.device_count()
        if local_world > cards:
            raise ValueError(
                'nccl cannot put %d ranks on %d card(s): NCCL refuses two '
                'ranks on one device; ask for backend=\'gloo\' to share a '
                'card' % (local_world, cards))
    if dev.type == 'cuda':
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend, init_method=init_method, world_size=world, rank=r,
        timeout=datetime.timedelta(seconds=timeout_s))
    return Mesh(r, world, dev, backend, owner=True)


def local_batch_size(global_batch, mesh):
    """A rank's share of ``global_batch`` over ``mesh`` (or a world size);
    raises when it does not divide."""
    n = mesh if isinstance(mesh, int) else mesh.shape[DATA_AXIS]
    if global_batch % n:
        raise ValueError('global batch %d not divisible by %d devices'
                         % (global_batch, n))
    return global_batch // n


def pad_to_devices(arr, n_dev):
    """``arr`` with its first rows appended until its row count divides
    ``n_dev`` (the JAX ``Trainer._pad_to_devices``: rows wrap around)."""
    r = (-arr.shape[0]) % n_dev
    if not r:
        return arr
    if torch.is_tensor(arr):
        return torch.cat([arr, arr[:r]])
    return np.concatenate([arr, arr[:r]], axis=0)
