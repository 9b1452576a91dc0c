"""Switch filter-chain replay: the port of the TPU kernel ``_chain_kernel``
/ ``pallas_apply_filter_chain`` (``exposure_tpu/ops/pallas_chain.py``).

``apply_filter_chain_switch`` applies a K-step chain with per-image ids in
float32 or bfloat16.  On a CUDA tensor it launches the hand-written kernel
``csrc/switch_chain.cu`` (one launch) or raises; on a CPU tensor it runs
the plain PyTorch version ``apply_filter_chain_switch_reference``, which
shares the branch math of ``ops/dyn_chain.py``.  It serves the switch
replay mode, and the grouped runner's fallback and merges
(``ops/grouped_chain.py``), which use ``rows`` to replay a few images of a
batch in place.
"""

import torch

from exposure_tpu_torch.ops.dyn_chain import (
    branch_codes,
    check_inputs,
    check_plan_smem,
    check_rows,
    fold_active,
    from_planes,
    kernel_scalars,
    kernel_stream,
    mask_grid,
    planar_branches,
    replay_slots,
    run_steps,
    to_planes,
)

COMPUTE_DTYPES = (torch.float32, torch.bfloat16)


def apply_filter_chain_switch_reference(img, filter_ids, packed_params,
                                        filters, active_steps=None,
                                        mask_params=None,
                                        compute_dtype=torch.float32,
                                        fast_math=False, rows=None, out=None,
                                        n_active=None):
    """Plain PyTorch version of the kernel, on any device.  The pixels,
    the parameters (cast as the TPU kernel casts them) and the mask grid
    are in ``compute_dtype``; u8 is quantized from the float32 value."""
    check_inputs(img, filter_ids, packed_params, active_steps, mask_params)
    check_rows(img, rows, out)
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError('compute_dtype must be float32 or bfloat16')
    masking = any(f.use_masking() for f in filters)
    if masking and mask_params is None:
        raise ValueError('masking filters require mask_params')
    idx, _, _ = replay_slots(img, rows, n_active)
    ids = fold_active(filter_ids, active_steps, len(filters))
    params = packed_params
    if masking:
        params = torch.cat([params, mask_params], dim=-1)
    ids = ids[:, idx].transpose(0, 1)
    params = params[:, idx].transpose(0, 1).to(torch.float32) \
        .to(compute_dtype)
    branches = planar_branches(
        filters, packed_params.shape[-1] if masking else None, fast_math)
    r, g, b = to_planes(img[idx], compute_dtype)
    gx, gy = mask_grid(img.shape[1], img.shape[2], img.device,
                       compute_dtype) if masking else (None, None)
    r, g, b = run_steps(r, g, b, ids, params, branches, gx, gy)
    y = from_planes(r, g, b, img.dtype)
    if rows is None and out is None and idx.numel() == img.shape[0]:
        return y
    if out is None:
        out = torch.empty_like(img)
    out[idx] = y
    return out


def apply_filter_chain_switch(img, filter_ids, packed_params, filters,
                              active_steps=None, mask_params=None,
                              compute_dtype=torch.float32, fast_math=False,
                              rows=None, out=None, n_active=None):
    """Replay a K-step trajectory with per-image ids (the contract of
    ``pallas_apply_filter_chain``).

    Args:
      img: [B, H, W, 3] uint8 or float32 (linear [0, 1] domain).
      filter_ids: [K, B] integer ids into ``filters``; ``len(filters)``
        (or any id outside the bank) is the identity.
      packed_params: [K, B, P] float32 regressed parameters.
      filters: the instantiated bank.
      active_steps: optional [K, B] 0/1 mask; inactive steps are identity.
      mask_params: [K, B, M] raw mask parameters, required when masking.
      compute_dtype: ``torch.float32`` or ``torch.bfloat16``, the type of
        the pixel math.  u8 output is quantized in float32.
      fast_math: the fast branch set.
      rows: optional [n] int32 image indices.  Slot i replays image
        ``rows[i]`` with that image's ids and parameters and writes the
        result to ``out[rows[i]]``; the other images of ``out`` are left
        as they are.  Without ``rows`` slot i is image i.
      out: the [B, H, W, 3] output buffer (a new one when None).
      n_active: only slots below it are replayed (default: all).

    Returns ``out``, of the input's dtype.  A CPU tensor runs the plain
    PyTorch version; a CUDA tensor launches the kernel or raises.
    """
    if img.device.type == 'cpu':
        return apply_filter_chain_switch_reference(
            img, filter_ids, packed_params, filters,
            active_steps=active_steps, mask_params=mask_params,
            compute_dtype=compute_dtype, fast_math=fast_math, rows=rows,
            out=out, n_active=n_active)
    if img.device.type != 'cuda':
        raise ValueError('no chain kernel for device %s' % img.device)
    check_inputs(img, filter_ids, packed_params, active_steps, mask_params)
    check_rows(img, rows, out)
    if compute_dtype not in COMPUTE_DTYPES:
        raise TypeError('compute_dtype must be float32 or bfloat16')
    if not img.is_contiguous() or (out is not None and
                                   not out.is_contiguous()):
        raise ValueError('img and out must be contiguous')
    if packed_params.dtype != torch.float32 or (
            mask_params is not None and mask_params.dtype != torch.float32):
        raise TypeError('params must be float32')
    masking = any(f.use_masking() for f in filters)
    if masking and (mask_params is None or mask_params.shape[-1] < 6):
        raise ValueError('the kernel reads 6 mask parameters per step')
    # validates the bank (unsupported filters raise here, as on the CPU)
    planar_branches(filters, packed_params.shape[-1] if masking else None)
    codes = branch_codes(filters)
    _, n, n_active = replay_slots(img, rows, n_active)
    num_steps, batch = filter_ids.shape
    pp = packed_params.shape[-1]
    m = mask_params.shape[-1] if masking else 0
    bf16 = compute_dtype == torch.bfloat16
    # both compute types stage K codes and K per-step plans of 4-byte entries
    check_plan_smem(num_steps, filters)
    ids = fold_active(filter_ids, active_steps, len(filters)) \
        .to(torch.int32).contiguous()
    params = packed_params.contiguous()
    mask = mask_params.contiguous() if masking else None
    rows_i32 = rows.to(torch.int32).contiguous() if rows is not None \
        else None
    if out is None:
        out = torch.empty_like(img)
    h, w = img.shape[1], img.shape[2]
    from exposure_tpu_torch.kernels import switch_chain_library
    lib = switch_chain_library()
    if n_active == 0:   # nothing to replay: no launch
        return out
    with torch.cuda.device(img.device):
        err = lib.switch_chain_launch(
            img.data_ptr(), out.data_ptr(), ids.data_ptr(),
            params.data_ptr(), mask.data_ptr() if masking else None,
            rows_i32.data_ptr() if rows_i32 is not None else None,
            codes, len(filters), n, n_active, batch, h, w, num_steps, pp, m,
            int(img.dtype == torch.uint8),
            int(bf16), int(bool(fast_math)),
            int(masking), *kernel_scalars(filters, h, w),
            kernel_stream(img.device))
    if err != 0:
        raise RuntimeError('switch_chain kernel launch failed: %s'
                           % lib.switch_chain_error_string(err).decode())
    apply_filter_chain_switch.launches += 1
    apply_filter_chain_switch.launches_bf16 += int(bf16)
    return out


# Kernel launches by apply_filter_chain_switch (CPU calls do not count), and
# those among them in bfloat16.
apply_filter_chain_switch.launches = 0
apply_filter_chain_switch.launches_bf16 = 0
