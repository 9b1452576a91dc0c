"""What the serving cells' per-layer readers share: the traced batches cut
out of the trace, each kernel put in its layer by name, and the counts of
the traced batches on the reference.  Each result is computed once a run
and kept in the readers' context.

A batch on the card is one graph replay between two copies: the input
copied into the graph's buffer, then the proxy resize (the uint8 -> float32
conversion and scaling, ``direct_copy`` and ``Mul`` kernels, then the
antialiased ``upsample_gen2d_aa`` kernel and the copy after it), the plan
(every other kernel), the full-resolution replay (the uint8
``dyn_chain_kernel``), then the output's copy.  Kernel names, not ranges in
the program, draw the lines (the program has no spans yet)."""

K1_FULL = 'dyn_chain_kernel<unsigned char'
RESIZE = 'upsample_gen2d_aa_out_frame'
CONVERSIONS = ('direct_copy_kernel_cuda', 'MulFunctor')
COPY = 'Memcpy'


def split(trace):
    """The traced batches: lists of ``(name, start, end)``, each ending
    with the copy after its full-resolution replay."""
    out, cur = [], []
    events = trace.device
    for i, ev in enumerate(events):
        cur.append(ev)
        if K1_FULL in ev[0]:
            if i + 1 < len(events) and COPY in events[i + 1][0]:
                continue            # take the output's copy along
            out.append(cur)
            cur = []
        elif COPY in ev[0] and len(cur) > 1 and K1_FULL in cur[-2][0]:
            out.append(cur)
            cur = []
    return out


def parts(batch):
    """``{'resize', 'plan', 'k1', 'copies'}`` device seconds of one
    batch."""
    at = next((i for i, ev in enumerate(batch) if RESIZE in ev[0]), None)
    if at is None:
        return None
    resize = 0.0
    for i, (name, s, e) in enumerate(batch):
        if i == at or (i == at + 1 and CONVERSIONS[0] in name) or (
                i < at and any(c in name for c in CONVERSIONS)):
            resize += e - s
    k1 = sum(e - s for name, s, e in batch if K1_FULL in name)
    copies = sum(e - s for name, s, e in batch if COPY in name)
    total = sum(e - s for _, s, e in batch)
    return {'resize': resize, 'k1': k1, 'copies': copies,
            'plan': total - resize - k1 - copies}


def batch_parts(ctx):
    """The parts of every whole traced batch, or None without a trace."""
    if 'serve_parts' not in ctx:
        trace = ctx.get('trace')
        found = None
        if trace is not None:
            found = [p for p in map(parts, split(trace)) if p is not None]
            found = found or None
        ctx['serve_parts'] = found
    return ctx['serve_parts']


def traced_ids(ctx):
    """The reference plan's ``[K, B]`` ids of each traced batch."""
    if 'serve_ids' not in ctx:
        from benchmark.drivers.serve import TRACE_INDEX
        from benchmark.reference.serve import chain_ids_for
        batches, seed = ctx['batches'], ctx['seed']
        n = len(batch_parts(ctx) or [])
        ctx['serve_ids'] = [
            chain_ids_for(ctx['ref'], batches[k % len(batches)], seed,
                          TRACE_INDEX + k).cpu().tolist() for k in range(n)]
    return ctx['serve_ids']


def chain_counts(ctx, ids):
    """``chain_cost`` of one batch's full-resolution replay."""
    from benchmark.counts.chain import chain_cost
    cfg, traffic = ctx['config']['config'], ctx['traffic']
    fast = traffic.get('pipeline', {}).get('fast_math', True)
    ref = ctx['ref']
    max_p = max(f.get_num_filter_parameters() for f in ref.filters)
    return chain_cost(ids, list(cfg['filters']), cfg['curve_steps'], max_p,
                      traffic['height'], traffic['width'], True, fast,
                      bool(cfg['masking']))
