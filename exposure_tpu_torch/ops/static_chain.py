"""Static filter-chain replay: the port of the TPU kernel
``_static_chain_kernel`` / ``pallas_apply_filter_chain_static``
(``exposure_tpu/ops/pallas_chain.py``).

``apply_filter_chain_static`` applies one K-step signature, shared by every
image of the call.  On a CUDA tensor it launches the hand-written kernel
``csrc/static_chain.cu`` (one launch) or raises; on a CPU tensor it runs
the plain PyTorch version ``apply_filter_chain_static_reference``, which
shares the branch math of ``ops/dyn_chain.py``.  The grouped runner
(``ops/grouped_chain.py``) replays each signature group through it, with
``rows`` gathering and scattering the group's images in place.
"""

import ctypes

import torch

from exposure_tpu_torch.ops.dyn_chain import (
    BRANCH_CODES,
    IDENTITY_CODE,
    check_image,
    check_plan_smem,
    check_params,
    check_rows,
    from_planes,
    kernel_scalars,
    kernel_stream,
    mask_grid,
    planar_branches,
    replay_slots,
    to_planes,
)

MAX_STEPS = 32    # kMaxSteps in the kernel


def _check(img, signature, packed_params, mask_params):
    check_image(img)
    check_params(img, len(signature), packed_params,
                 mask_params=mask_params)


def apply_filter_chain_static_reference(img, signature, packed_params,
                                        filters, mask_params=None,
                                        fast_math=False, n_active=None,
                                        rows=None, out=None):
    """Plain PyTorch version of the kernel, on any device."""
    _check(img, signature, packed_params, mask_params)
    check_rows(img, rows, out)
    masking = any(f.use_masking() for f in filters)
    if masking and mask_params is None:
        raise ValueError('masking filters require mask_params')
    idx, _, _ = replay_slots(img, rows, n_active)
    params = packed_params
    if masking:
        params = torch.cat([params, mask_params], dim=-1)
    params = params[:, idx].to(torch.float32)
    branches = planar_branches(
        filters, packed_params.shape[-1] if masking else None, fast_math)
    r, g, b = to_planes(img[idx])
    gx, gy = mask_grid(img.shape[1], img.shape[2], img.device) \
        if masking else (None, None)
    for k, fid in enumerate(signature):
        if 0 <= int(fid) < len(branches):
            p = params[k][:, :, None, None].unbind(1)
            r, g, b = branches[int(fid)](r, g, b, p, gx, gy)
    y = from_planes(r, g, b, img.dtype)
    if rows is None and out is None and idx.numel() == img.shape[0]:
        return y
    if out is None:
        out = torch.empty_like(img)
    out[idx] = y
    return out


def apply_filter_chain_static(img, signature, packed_params, filters,
                              mask_params=None, fast_math=False,
                              n_active=None, rows=None, out=None):
    """Replay one static trajectory signature (the contract of
    ``pallas_apply_filter_chain_static``).

    Args:
      img: [B, H, W, 3] uint8 or float32.
      signature: K python ints, the filter of each step, shared by every
        image (``len(filters)`` or any id outside the bank is the
        identity).
      packed_params: [K, B, P] float32.
      mask_params: [K, B, M], required when masking.
      fast_math: the fast branch set.
      n_active: a python int; only slots below it are replayed, and the
        output of the other slots is unspecified (left as ``out`` had it).
      rows: optional [n] int32 image indices.  Slot i replays image
        ``rows[i]`` with its parameters and writes ``out[rows[i]]``;
        without ``rows`` slot i is image i.
      out: the [B, H, W, 3] output buffer (a new one when None).

    Returns ``out``, of the input's dtype.  A CPU tensor runs the plain
    PyTorch version; a CUDA tensor launches the kernel or raises.
    """
    if img.device.type == 'cpu':
        return apply_filter_chain_static_reference(
            img, signature, packed_params, filters, mask_params=mask_params,
            fast_math=fast_math, n_active=n_active, rows=rows, out=out)
    if img.device.type != 'cuda':
        raise ValueError('no chain kernel for device %s' % img.device)
    _check(img, signature, packed_params, mask_params)
    check_rows(img, rows, out)
    if not img.is_contiguous() or (out is not None and
                                   not out.is_contiguous()):
        raise ValueError('img and out must be contiguous')
    if packed_params.dtype != torch.float32 or (
            mask_params is not None and mask_params.dtype != torch.float32):
        raise TypeError('params must be float32')
    num_steps = len(signature)
    if not 0 < num_steps <= MAX_STEPS:
        raise ValueError('the kernel takes 1 to %d steps, got %d'
                         % (MAX_STEPS, num_steps))
    masking = any(f.use_masking() for f in filters)
    if masking and (mask_params is None or mask_params.shape[-1] < 6):
        raise ValueError('the kernel reads 6 mask parameters per step')
    # validates the bank (unsupported filters raise here, as on the CPU)
    planar_branches(filters, packed_params.shape[-1] if masking else None)
    codes = [BRANCH_CODES[type(filters[int(s)]).__name__]
             if 0 <= int(s) < len(filters) else IDENTITY_CODE
             for s in signature]
    _, n, n_active = replay_slots(img, rows, n_active)
    batch, h, w = img.shape[0], img.shape[1], img.shape[2]
    pp = packed_params.shape[-1]
    m = mask_params.shape[-1] if masking else 0
    check_plan_smem(num_steps, filters)
    params = packed_params.contiguous()
    mask = mask_params.contiguous() if masking else None
    rows_i32 = rows.to(torch.int32).contiguous() if rows is not None \
        else None
    if out is None:
        out = torch.empty_like(img)
    from exposure_tpu_torch.kernels import static_chain_library
    lib = static_chain_library()
    if n_active == 0:   # nothing to replay: no launch
        return out
    with torch.cuda.device(img.device):
        err = lib.static_chain_launch(
            img.data_ptr(), out.data_ptr(), params.data_ptr(),
            mask.data_ptr() if masking else None,
            rows_i32.data_ptr() if rows_i32 is not None else None,
            (ctypes.c_int * num_steps)(*codes), n, n_active, batch, h, w,
            num_steps, pp, m, int(img.dtype == torch.uint8),
            int(bool(fast_math)), int(masking),
            *kernel_scalars(filters, h, w), kernel_stream(img.device))
    if err != 0:
        raise RuntimeError('static_chain kernel launch failed: %s'
                           % lib.static_chain_error_string(err).decode())
    apply_filter_chain_static.launches += 1
    return out


# Kernel launches by apply_filter_chain_static (CPU calls do not count).
apply_filter_chain_static.launches = 0
