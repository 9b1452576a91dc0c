"""Signature-grouped replay (torch counterpart of ``GroupedChainRunner`` in
``exposure_tpu/ops/pallas_chain.py``).

The runner groups a batch by trajectory signature (the K filter ids of an
image) on the host and replays each group through the static chain (K3,
``ops/static_chain.py``); the switch chain (K2, ``ops/switch_chain.py``)
takes the batches and the leftovers that grouping does not serve.  It
keeps every routing decision of the JAX runner:

- ``fallback``: more than ``max_signatures`` signatures, one K2 call on
  the batch;
- ``single``: one signature, one K3 call on the batch as it is;
- ``fused``: the first ``fused_set_limit`` distinct signature sets (group
  signatures with bucketed sizes), one K3 call per group;
- ``accumulate``: later sets; groups of at least ``merge_below`` images
  get a K3 call each, the smaller ones merge into one K2 call (a lone
  small group keeps its own K3 call);
- ``superset`` (``call_superset``): a frozen (signature, bucket) layout;
  images whose signature is missing or that overflow their slot merge
  into one K2 call.

On the TPU each route was a compiled program, cached per shape; here
every call of a kernel is one launch and nothing is compiled, so the
cache is gone.  Each group's call gathers its images and scatters its
results through ``rows`` inside the kernel.  Group sizes are still
padded to ``bucket_size`` with the group's first image and the padded
slots skipped through ``n_active``, so the routes and the warm-up budget
read as the JAX runner's.  ``last_route`` records the route of the last
call and ``launches`` counts the kernel calls the runner made (on the CPU
they run the kernels' plain versions).  ``routes`` is the set of distinct
routes the runner has run, keyed as the JAX runner keyed its compiled
programs (``_fns``) less the compile-only parts of those keys: a
``('single', signature, B, (H, W), dtype)``, ``('fused', groups, ...)``,
``('acc', signature, bucket, ...)``, ``('merge', bucket, ...)``,
``('superset', layout, ...)`` or ``('fallback', shape, dtype)``; the
warm-ups add theirs, so what traffic adds after a warm-up is what the
warm-up missed.
"""

import collections

import numpy as np
import torch

from exposure_tpu_torch.ops.static_chain import apply_filter_chain_static
from exposure_tpu_torch.ops.switch_chain import apply_filter_chain_switch


def bucket_size(n):
    """Group-size bucket: the next value in {8, 12, 16, 24, 32, 48, ...}
    (powers of two and their 1.5x midpoints), as the JAX runner's
    ``_bucket_size``."""
    if n <= 8:
        return 8
    p = 1 << (n - 1).bit_length()        # next pow2 >= n
    mid = p // 2 + p // 4                # 1.5 * previous pow2
    return mid if n <= mid else p


def upload(array, device):
    """A small host int32 array on ``device``; to a GPU through pinned
    memory and a non-blocking copy, so the host does not wait."""
    host = torch.from_numpy(np.ascontiguousarray(array, dtype=np.int32))
    if torch.device(device).type == 'cpu':
        return host
    pinned = torch.empty(host.shape, dtype=torch.int32, pin_memory=True)
    pinned.copy_(host)
    return pinned.to(device, non_blocking=True)


def _groups(ids):
    """[K, B] host ids -> ([(signature, [image indices])] sorted by
    signature, each group's indices ascending)."""
    cols = np.ascontiguousarray(ids.astype(np.int64, copy=False).T)
    uniq, inv = np.unique(cols, axis=0, return_inverse=True)
    inv = inv.reshape(-1)
    order = np.argsort(inv, kind='stable')
    bounds = np.searchsorted(inv[order], np.arange(len(uniq) + 1))
    return [(tuple(int(x) for x in uniq[g]),
             order[bounds[g]:bounds[g + 1]].tolist())
            for g in range(len(uniq))]


def _layout_key(layout):
    return tuple((tuple(int(x) for x in sig), int(size))
                 for sig, size in layout)


def _padded(idxs, size):
    """Indices padded to ``size`` with the first (skipped via n_active)."""
    return list(idxs) + [idxs[0]] * (size - len(idxs))


class GroupedChainRunner:

    def __init__(self, filters, max_signatures=16, fast_math=False,
                 fused_set_limit=4, merge_below=8):
        self.filters = filters
        self.masking = any(f.use_masking() for f in filters)
        self.max_signatures = max_signatures
        self.fast_math = fast_math
        # signature sets that took the fused route; after fused_set_limit
        # of them a new set takes the accumulate route
        self.fused_set_limit = fused_set_limit
        self.merge_below = merge_below
        self._fused_sets = set()
        self.last_route = None
        self.launches = collections.Counter()
        self.routes = set()

    @staticmethod
    def _at(img_shape, dtype):
        """The part of a route's key that the batch's shape gives: its
        (H, W) and dtype."""
        return (tuple(int(x) for x in img_shape[1:3]),
                str(dtype).replace('torch.', ''))

    # -- the two kernels -----------------------------------------------------
    def _static(self, img, sig, params, mask, out, rows=None, n_active=None):
        self.launches['static_chain'] += 1
        return apply_filter_chain_static(
            img, sig, params, self.filters,
            mask_params=mask if self.masking else None,
            fast_math=self.fast_math, n_active=n_active, rows=rows, out=out)

    def _switch(self, img, ids_dev, params, mask, out, rows=None,
                n_active=None):
        self.launches['switch_chain'] += 1
        return apply_filter_chain_switch(
            img, ids_dev, params, self.filters,
            mask_params=mask if self.masking else None,
            fast_math=self.fast_math, rows=rows, out=out, n_active=n_active)

    def _static_groups(self, img, params, mask, out, groups):
        """One K3 call per ``(signature, bucket, indices)`` group into
        ``out``; every group's padded rows come in one upload."""
        if not groups:
            return
        rows = upload(np.concatenate(
            [_padded(ix, size) for _, size, ix in groups]), img.device)
        o = 0
        for sig, size, ix in groups:
            self._static(img, sig, params, mask, out, rows=rows[o:o + size],
                         n_active=len(ix))
            o += size

    def _merge(self, img, ids_dev, params, mask, out, idxs):
        """Replay ``idxs`` (any signatures) through one K2 call into
        ``out``; returns the merge bucket size."""
        size = bucket_size(len(idxs))
        rows = upload(_padded(idxs, size), img.device)
        self._switch(img, ids_dev, params, mask, out, rows=rows,
                     n_active=len(idxs))
        return size

    def _host_ids(self, filter_ids, ids_host, active_steps):
        """The [K, B] host ids grouping uses (inactive steps folded to the
        identity id), and the device ids the switch kernel reads."""
        n_filters = len(self.filters)
        if ids_host is None:
            ids_host = filter_ids.cpu().numpy()  # waits for the plan
        ids_host = np.asarray(ids_host)
        ids_dev = filter_ids
        if active_steps is not None:
            act = active_steps.cpu().numpy() if torch.is_tensor(active_steps) \
                else np.asarray(active_steps)
            ids_host = np.where(act > 0, ids_host, n_filters)
            ids_dev = None
        return ids_host, ids_dev

    def _device_ids(self, img, ids_dev, ids_host):
        if ids_dev is None or ids_dev.device != img.device:
            return upload(ids_host, img.device)
        return ids_dev

    # -- routing ---------------------------------------------------------
    def program_plan(self, ids):
        """Which route a batch with these [K, B] host ids (identity
        folded) would take, as the JAX ``program_plan``:
        ``{'kind': 'fallback'|'single'|'groups', 'single_size': B?,
        'big': [(sig, bucket), ...], 'merge': remainder_bucket|None}``."""
        groups = _groups(ids)
        if len(groups) > self.max_signatures:
            return {'kind': 'fallback'}
        if len(groups) == 1:
            return {'kind': 'single', 'sig': groups[0][0],
                    'single_size': ids.shape[1]}
        big, small = self._split(groups)
        return {
            'kind': 'groups',
            'big': [(sig, bucket_size(len(ix))) for sig, ix in big],
            'merge': bucket_size(sum(len(ix) for _, ix in small))
            if small else None,
        }

    def _split(self, groups):
        big = [(s, ix) for s, ix in groups if len(ix) >= self.merge_below]
        small = [(s, ix) for s, ix in groups if len(ix) < self.merge_below]
        if len(small) == 1:   # a lone small group keeps its own K3 call
            big.append(small[0])
            small = []
        return big, small

    def __call__(self, img, filter_ids, packed_params, active_steps=None,
                 mask_params=None, ids_host=None):
        """Replay a batch.

        Args:
          img: [B, H, W, 3] u8 or f32.
          filter_ids: [K, B] ids on the image's device.
          packed_params: [K, B, P] f32; mask_params [K, B, M] when masking.
          active_steps: optional [K, B] 0/1.
          ids_host: the same ids as a host array, when the caller already
            has them (otherwise they are copied here, which waits for the
            device).
        """
        ids, ids_dev = self._host_ids(filter_ids, ids_host, active_steps)
        groups = _groups(ids)
        if len(groups) > self.max_signatures:
            # signature-diverse batch: one K2 call
            self.last_route = {'route': 'fallback', 'signatures': len(groups)}
            self.routes.add(('fallback', tuple(img.shape),
                             self._at(img.shape, img.dtype)[1]))
            return self._switch(img, self._device_ids(img, ids_dev, ids),
                                packed_params, mask_params, None)
        if len(groups) == 1:
            sig = groups[0][0]
            self.last_route = {'route': 'single', 'signature': sig}
            self.routes.add(('single', sig, img.shape[0]) +
                            self._at(img.shape, img.dtype))
            return self._static(img, sig, packed_params, mask_params, None)

        out = torch.empty_like(img)
        set_key = tuple((sig, bucket_size(len(ix))) for sig, ix in groups)
        if set_key in self._fused_sets or \
                len(self._fused_sets) < self.fused_set_limit:
            # fused: every group its own K3 call, small ones included
            self._fused_sets.add(set_key)
            self._static_groups(
                img, packed_params, mask_params, out,
                [(sig, size, ix) for (sig, ix), (_, size)
                 in zip(groups, set_key)])
            self.last_route = {'route': 'fused', 'groups': list(set_key),
                               'merge': None}
            self.routes.add(('fused', set_key) +
                            self._at(img.shape, img.dtype))
            return out

        # accumulate: big groups one K3 call each, small ones merged
        big, small = self._split(groups)
        sizes = [bucket_size(len(ix)) for _, ix in big]
        self._static_groups(img, packed_params, mask_params, out,
                            [(sig, size, ix) for (sig, ix), size
                             in zip(big, sizes)])
        merge = None
        if small:
            merge = self._merge(img, self._device_ids(img, ids_dev, ids),
                                packed_params, mask_params, out,
                                [i for _, ix in small for i in ix])
        at = self._at(img.shape, img.dtype)
        self.routes.update(('acc', sig, size) + at
                           for (sig, _), size in zip(big, sizes))
        if merge is not None:
            self.routes.add(('merge', merge) + at)
        self.last_route = {
            'route': 'accumulate',
            'groups': [(sig, size) for (sig, _), size in zip(big, sizes)],
            'merge': merge,
            'merged_rows': sum(len(ix) for _, ix in small)}
        return out

    def call_superset(self, img, ids, packed_params, layout,
                      mask_params=None, ids_device=None):
        """Replay a batch through a frozen (signature, bucket) layout.

        ``ids``: [K, B] host ids, identity folded.  Each group goes into
        its signature's slot, one K3 call per slot (an empty slot makes
        no call); images whose signature is missing from the layout or
        that overflow their slot's bucket merge into one K2 call.  A
        single-signature batch takes the whole-batch K3 call.
        ``ids_device``: the same ids on the image's device, if at hand.
        """
        ids = np.asarray(ids)
        groups = _groups(ids)
        if len(groups) == 1:
            sig = groups[0][0]
            self.last_route = {'route': 'single', 'signature': sig}
            self.routes.add(('single', sig, img.shape[0]) +
                            self._at(img.shape, img.dtype))
            return self._static(img, sig, packed_params, mask_params, None)
        slot_of = {sig: g for g, (sig, _) in enumerate(layout)}
        take = [[] for _ in layout]
        leftover = []
        for sig, idxs in groups:
            slot = slot_of.get(sig)
            if slot is None:
                leftover.extend(idxs)
                continue
            size = layout[slot][1]
            take[slot] = idxs[:size]
            leftover.extend(idxs[size:])
        out = torch.empty_like(img)
        filled = [(sig, size, ix) for (sig, size), ix in zip(layout, take)
                  if ix]
        self._static_groups(img, packed_params, mask_params, out, filled)
        merge = None
        if leftover:
            merge = self._merge(img, self._device_ids(img, ids_device, ids),
                                packed_params, mask_params, out,
                                sorted(leftover))
        at = self._at(img.shape, img.dtype)
        self.routes.add(('superset', _layout_key(layout)) + at)
        if merge is not None:
            self.routes.add(('merge', merge) + at)
        self.last_route = {
            'route': 'superset', 'slots': len(layout),
            'filled_slots': len(filled), 'merge': merge,
            'merged_rows': len(leftover)}
        return out

    # -- warm-up ---------------------------------------------------------
    def warmup(self, budget, img_shape, dtype, num_steps, max_p, mask_p=1,
               merge_sizes=(), device='cuda'):
        """Run each route a declared traffic budget will take once, on
        padded-only rows (``n_active`` 0, so no kernel is launched): one
        K3 call per (signature, bucket) pair and one K2 call per merge
        size.  Nothing is compiled per route; this builds and loads the
        kernel libraries ahead of traffic.  Returns the number of routes
        added to ``routes``.  ``device``: where traffic will run, the card
        unless the caller asks for the CPU."""
        before = len(self.routes)
        self._warm(budget, merge_sizes, img_shape, dtype, num_steps, max_p,
                   mask_p, device)
        at = self._at(img_shape, dtype)
        self.routes.update(('acc', tuple(sig), int(size)) + at
                           for sig, size in budget)
        self.routes.update(('merge', int(size)) + at for size in merge_sizes)
        return len(self.routes) - before

    def warmup_superset(self, layout, img_shape, dtype, num_steps, max_p,
                        mask_p=1, merge_sizes=(), device='cuda'):
        """Run the frozen layout's slots and the leftover merges once on
        padded-only rows.  Returns the number of routes added: one for the
        layout, one per merge size."""
        before = len(self.routes)
        self._warm(layout, merge_sizes, img_shape, dtype, num_steps, max_p,
                   mask_p, device)
        at = self._at(img_shape, dtype)
        if layout:
            self.routes.add(('superset', _layout_key(layout)) + at)
        self.routes.update(('merge', int(size)) + at for size in merge_sizes)
        return len(self.routes) - before

    def _warm(self, budget, merge_sizes, img_shape, dtype, num_steps, max_p,
              mask_p, device):
        img, params, mask, ids = self._zeros(img_shape, dtype, num_steps,
                                             max_p, mask_p, device)
        out = torch.empty_like(img)
        for sig, size in budget:
            rows = torch.zeros(size, dtype=torch.int32, device=img.device)
            self._static(img, tuple(sig), params, mask, out, rows=rows,
                         n_active=0)
        for size in merge_sizes:
            rows = torch.zeros(size, dtype=torch.int32, device=img.device)
            self._switch(img, ids, params, mask, out, rows=rows, n_active=0)

    def _zeros(self, img_shape, dtype, num_steps, max_p, mask_p, device):
        b = img_shape[0]
        img = torch.zeros(tuple(img_shape), dtype=dtype, device=device)
        params = torch.zeros((num_steps, b, max_p), device=device)
        mask = torch.zeros((num_steps, b, mask_p), device=device) \
            if self.masking else None
        ids = torch.full((num_steps, b), len(self.filters),
                         dtype=torch.int32, device=device)
        return img, params, mask, ids
