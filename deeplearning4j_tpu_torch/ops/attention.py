"""Scaled dot-product attention: plain tiers and the hand-written kernels.

Counterpart of the JAX package's ``deeplearning4j_tpu/ops/attention.py``;
the same functions, signatures and semantics:

- ``reference_attention``: full materialization (the test oracle);
- ``blockwise_attention``: online softmax over key blocks, a Python loop in
  place of ``lax.scan`` (differentiable through autograd);
- ``decode_attention`` / ``cache_update``: the KV-cached single-token step;
- ``flash_attention``: the forward kernel ``csrc/flash_attention.cu``
  (replacing the Pallas ``_fwd_kernel``), with ``flash_attention_plain``;
- ``paged_decode_attention``: the decode kernel
  ``csrc/paged_decode_attention.cu`` (replacing ``_paged_decode_kernel``),
  with ``paged_decode_attention_plain``;
- ``dot_product_attention``: the dispatcher over the stock tiers.

``q, k, v: [batch, heads, time, head_dim]``; ``key_mask: [batch, time_k]``
(valid where ``> 0``); causal means key ``col <= row + (Tk - Tq)``. Masked
scores are SET to ``NEG_INF = -1e30``, not ``-inf``, so a fully masked row
averages its values instead of producing NaN, and the scale multiplies the
dot product after it is formed.

Each kernel wrapper runs its plain version for CPU tensors and launches its
kernel for CUDA tensors, or raises: there is no fallback. It counts its
launches in ``<wrapper>.launches``. ``flash_attention`` has no backward on
the card yet (TPU kernel rows 7-8, the next slice): on a CUDA tensor that
requires grad it raises rather than return an output without a gradient.
"""

from __future__ import annotations

import ctypes
import math

import torch

NEG_INF = -1e30
_DTYPES = (torch.float32, torch.bfloat16)

_FLASH_SIGNATURES = {
    "dl4j_flash_attention_fwd": (
        ctypes.c_int,
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5 + [ctypes.c_longlong] * 9
        + [ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_int,
           ctypes.c_void_p]),
}
_DECODE_SIGNATURES = {
    "dl4j_paged_decode_attention": (
        ctypes.c_int,
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]),
}
_MAX_PAGE = 64
_MAX_HEAD_DIM = 512


def _scale(q, scale):
    return (1.0 / math.sqrt(q.shape[-1])) if scale is None else scale


def head_dim_supported(d: int) -> bool:
    """The head sizes both kernels take: up to 128, or a multiple of 128 up
    to 512 (the JAX package's flash qualifier, capped at the largest
    register tile the CUDA kernels instantiate)."""
    return 0 < d and (d <= 128 or (d % 128 == 0 and d <= _MAX_HEAD_DIM))


def _keep_mask(b, tq, tk, key_mask, causal, device):
    """Boolean [b or 1, 1, tq, tk] of the scores that are kept, or None."""
    keep = None
    if key_mask is not None:
        keep = (key_mask > 0)[:, None, None, :]
    if causal:
        rows = torch.arange(tq, device=device)[:, None] + (tk - tq)
        cm = (torch.arange(tk, device=device)[None, :] <= rows)[None, None]
        keep = cm if keep is None else keep & cm
    return keep


# ---------------------------------------------------------------------------
# Tier 0: reference (oracle)
# ---------------------------------------------------------------------------

def reference_attention(q, k, v, key_mask=None, causal=False, scale=None):
    """Full-materialization attention; the test oracle."""
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * _scale(q, scale)
    keep = _keep_mask(q.shape[0], q.shape[2], k.shape[2], key_mask, causal,
                      q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


# ---------------------------------------------------------------------------
# KV-cached single-token decode
# ---------------------------------------------------------------------------

def decode_attention(q, k_cache, v_cache, positions, scale=None):
    """One decode step of causal attention against a preallocated KV cache:
    ``q [batch, heads, head_dim]``, ``k_cache/v_cache [batch, max_len,
    heads, head_dim]`` (the new token's own k/v already written), slots
    ``0..positions[b]`` inclusive attended, the rest masked to ``NEG_INF``
    (finite garbage in unwritten slots never leaks)."""
    s = torch.einsum("bhd,bshd->bhs", q, k_cache) * _scale(q, scale)
    live = (torch.arange(k_cache.shape[1], device=q.device)[None, :]
            <= positions[:, None])
    s = s.masked_fill(~live[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhs,bshd->bhd", p, v_cache)


def cache_update(cache, new, positions):
    """Write ``new [batch, t, heads, head_dim]`` into ``cache [batch,
    max_len, heads, head_dim]`` at slot ``positions[b]`` of each row, IN
    PLACE, and return ``cache``. The start clamps to ``[0, max_len - t]``
    (``dynamic_update_slice``'s rule, which the JAX package relies on:
    only retired rows sit that far, and their slots are never attended).
    Runs on the device without reading ``positions`` back."""
    s, t = cache.shape[1], new.shape[1]
    start = positions.long().clamp(0, s - t)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    slots = start[:, None] + torch.arange(t, device=cache.device)[None, :]
    cache[rows, slots] = new.to(cache.dtype)
    return cache


# ---------------------------------------------------------------------------
# Tier 1: blockwise online softmax (plain PyTorch, any device)
# ---------------------------------------------------------------------------

def blockwise_attention(q, k, v, key_mask=None, causal=False, scale=None,
                        block_k: int = 128):
    """Online softmax over key blocks of ``block_k``: never materializes the
    [Tq, Tk] matrix. f32 running max, sum and accumulator; differentiable
    through autograd."""
    b, h, tq, d = q.shape
    tk = k.shape[2]
    sm = _scale(q, scale)
    bk = min(block_k, tk)
    q32 = q.float()
    km = (None if key_mask is None else key_mask.to(q.dtype))
    qpos = torch.arange(tq, device=q.device)[:, None] + (tk - tq)
    acc = torch.zeros((b, h, tq, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, tq), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((b, h, tq), dtype=torch.float32, device=q.device)
    for j0 in range(0, tk, bk):
        kb = k[:, :, j0:j0 + bk].float()
        vb = v[:, :, j0:j0 + bk].float()
        s = torch.einsum("bhqd,bhkd->bhqk", q32, kb) * sm
        if km is not None:
            s = s.masked_fill(~(km[:, None, None, j0:j0 + bk] > 0), NEG_INF)
        if causal:
            kpos = j0 + torch.arange(kb.shape[2], device=q.device)[None, :]
            s = s.masked_fill(~(kpos <= qpos)[None, None], NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bhkd->bhqd", p, vb)
        m = m_new
    return (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)


# ---------------------------------------------------------------------------
# flash attention forward: the kernel and its plain version
# ---------------------------------------------------------------------------

def flash_attention_plain(q, k, v, key_mask=None, causal=False, scale=None):
    """The flash kernel's function in plain PyTorch: ``(o, l, m)`` with
    ``m [B,H,Tq]`` the row max of the masked, scaled f32 scores, ``l`` the
    sum of ``exp(s - m)``, and ``o = sum(p' v) / l`` where ``p'`` is ``p``
    rounded to v's dtype (bf16 rounds, as the kernel does before its
    p . v product). Rows with no valid key average uniformly; the kernel
    visits fewer keys for them, so only their finiteness is shared."""
    s = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * _scale(q, scale)
    keep = _keep_mask(q.shape[0], q.shape[2], k.shape[2], key_mask, causal,
                      q.device)
    if keep is not None:
        s = s.masked_fill(~keep, NEG_INF)
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None])
    l = p.sum(dim=-1)
    o = torch.einsum("bhqk,bhkd->bhqd", p.to(v.dtype).float(), v.float())
    return (o / l[..., None]).to(q.dtype), l, m


def _check_attention(q, k, v, key_mask):
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention takes q [B,H,Tq,D], k and v "
                         f"[B,H,Tk,D]; got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    if q.shape[:2] != k.shape[:2] or q.shape[3] != k.shape[3]:
        raise ValueError(f"flash_attention shape mismatch: q {tuple(q.shape)}"
                         f", k {tuple(k.shape)}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _DTYPES:
        raise ValueError(f"flash_attention takes float32 or bfloat16 "
                         f"operands of one dtype; got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"flash_attention operands on different devices: "
                         f"{q.device}, {k.device}, {v.device}")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if not head_dim_supported(q.shape[3]):
        raise ValueError(f"flash_attention takes head_dim <= 128 or a "
                         f"multiple of 128 up to {_MAX_HEAD_DIM}, got "
                         f"{q.shape[3]}")
    if key_mask is not None and tuple(key_mask.shape) != (q.shape[0],
                                                          k.shape[2]):
        raise ValueError(f"key_mask must be [B, Tk] = "
                         f"{(q.shape[0], k.shape[2])}, got "
                         f"{tuple(key_mask.shape)}")


def _flash_cuda(q, k, v, key_mask, causal, sm):
    # the layers import this module, and kernels/ imports the layers
    from deeplearning4j_tpu_torch.kernels import build, impls

    b, h, tq, d = q.shape
    tk = k.shape[2]
    q, k, v = (t if t.stride(-1) == 1 else t.contiguous() for t in (q, k, v))
    o = torch.empty((b, h, tq, d), dtype=q.dtype, device=q.device)
    l = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    m = torch.empty((b, h, tq), dtype=torch.float32, device=q.device)
    if o.numel() == 0:
        return o, l, m  # nothing to launch
    km = None
    if key_mask is not None:
        km = key_mask.to(device=q.device, dtype=torch.float32).contiguous()
    lib = build.load(impls.FLASH_SOURCE, _FLASH_SIGNATURES)
    rc = lib.dl4j_flash_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(),
        None if km is None else km.data_ptr(), o.data_ptr(), l.data_ptr(),
        m.data_ptr(), b, h, tq, tk, d, *q.stride()[:3], *k.stride()[:3],
        *v.stride()[:3], int(bool(causal)), float(sm),
        impls.DTYPE_IDS[q.dtype], q.device.index, impls.stream(q))
    impls.raise_on_error("flash_attention", rc)
    impls.count(flash_attention)
    return o, l, m


def flash_attention(q, k, v, key_mask=None, causal=False, scale=None,
                    return_stats: bool = False):
    """Causal/masked attention over ``[B, H, T, D]`` (float32 or bfloat16,
    f32 accumulation), through the flash kernel on the card. Returns ``o``,
    or ``(o, l, m)`` with ``return_stats`` (``l``, ``m``: [B,H,Tq] f32, the
    softmax sum and max the backward recomputes p from). Forward only on
    the card: a CUDA tensor that requires grad raises."""
    _check_attention(q, k, v, key_mask)
    sm = _scale(q, scale)
    if q.device.type == "cpu":
        out = flash_attention_plain(q, k, v, key_mask, causal, sm)
    else:
        if torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v)):
            raise NotImplementedError(
                "flash_attention has no backward on the card yet: its "
                "gradient kernels (TPU rows 7-8, _dq_kernel and _dkv_kernel) "
                "are ported with transformer training in the next slice")
        out = _flash_cuda(q, k, v, key_mask, causal, sm)
    return out if return_stats else out[0]


flash_attention.launches = 0


# ---------------------------------------------------------------------------
# paged decode attention: the kernel and its plain version
# ---------------------------------------------------------------------------

def paged_decode_attention_plain(q, k_cache, v_cache, positions, scale=None,
                                 page: int = 64):
    """The paged decode kernel's function in plain PyTorch: q . k as an f32
    sum of products, times the scale; slots past ``positions[b]`` set to
    ``NEG_INF``; softmax and p . v in f32 (p is not rounded), one rounding
    to q's dtype. ``positions[b] >= max_len`` attends the whole cache, and a
    negative position (no live page) gives zeros, as the kernel skips every
    page then."""
    s = torch.einsum("bhd,bshd->bhs", q.float(), k_cache.float())
    s = s * _scale(q, scale)
    pos = positions.to(device=q.device, dtype=torch.long)
    live = torch.arange(k_cache.shape[1], device=q.device)[None, :] \
        <= pos[:, None]
    s = s.masked_fill(~live[:, None, :], NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhs,bshd->bhd", p, v_cache.float())
    o = o.masked_fill((pos < 0)[:, None, None], 0.0)
    return o.to(q.dtype)


def _page(page, s):
    page = min(int(page), s)
    if page < 1 or page > _MAX_PAGE:
        raise ValueError(f"page must be in [1, {_MAX_PAGE}], got {page}")
    if s % page:
        raise ValueError(f"page {page} must divide cache length {s}")
    return page


def _check_decode(q, k_cache, v_cache, positions):
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.shape != k_cache.shape:
        raise ValueError(f"paged_decode_attention takes q [B,H,D] and caches "
                         f"[B,S,H,D]; got {tuple(q.shape)}, "
                         f"{tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, s, h, d = k_cache.shape
    if tuple(q.shape) != (b, h, d) or tuple(positions.shape) != (b,):
        raise ValueError(f"paged_decode_attention shape mismatch: q "
                         f"{tuple(q.shape)}, caches {tuple(k_cache.shape)}, "
                         f"positions {tuple(positions.shape)}")
    if not (q.dtype == k_cache.dtype == v_cache.dtype) \
            or q.dtype not in _DTYPES:
        raise ValueError(f"paged_decode_attention takes float32 or bfloat16 "
                         f"operands of one dtype; got {q.dtype}, "
                         f"{k_cache.dtype}, {v_cache.dtype}")
    if positions.dtype.is_floating_point or positions.dtype == torch.bool:
        raise ValueError(f"positions must be integers, got {positions.dtype}")
    if not (q.device == k_cache.device == v_cache.device
            == positions.device):
        raise ValueError("paged_decode_attention operands on different "
                         "devices")
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"paged_decode_attention runs on cpu or cuda, not "
                         f"{q.device}")
    if not head_dim_supported(d):
        raise ValueError(f"paged_decode_attention takes head_dim <= 128 or a "
                         f"multiple of 128 up to {_MAX_HEAD_DIM}, got {d}")


def _decode_cuda(q, k_cache, v_cache, positions, sm, page):
    from deeplearning4j_tpu_torch.kernels import build, impls

    if not (k_cache.is_contiguous() and v_cache.is_contiguous()):
        raise ValueError("paged_decode_attention needs contiguous caches")
    b, s, h, d = k_cache.shape
    q = q.contiguous()
    pos = positions.to(torch.int32).contiguous()
    o = torch.empty((b, h, d), dtype=q.dtype, device=q.device)
    if o.numel() == 0:
        return o
    lib = build.load(impls.DECODE_SOURCE, _DECODE_SIGNATURES)
    rc = lib.dl4j_paged_decode_attention(
        q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), pos.data_ptr(),
        o.data_ptr(), b, s, h, d, page, float(sm),
        impls.DTYPE_IDS[q.dtype], q.device.index, impls.stream(q))
    impls.raise_on_error("paged_decode_attention", rc)
    impls.count(paged_decode_attention)
    return o


def paged_decode_attention(q, k_cache, v_cache, positions, scale=None,
                           page: int = 64):
    """:func:`decode_attention` through the paged decode kernel on the
    card: ``q [B,H,D]``, caches ``[B,S,H,D]``, ``positions [B]``; the
    cache is read in ``min(page, S)``-slot pages (the page must divide S,
    and be at most 64), and pages wholly past ``positions[b]`` are neither
    read nor computed. Forward only (the decoder runs under
    ``torch.inference_mode``)."""
    _check_decode(q, k_cache, v_cache, positions)
    page = _page(page, k_cache.shape[1])
    sm = _scale(q, scale)
    if q.device.type == "cpu":
        return paged_decode_attention_plain(q, k_cache, v_cache, positions,
                                            sm, page)
    return _decode_cuda(q, k_cache, v_cache, positions, sm, page)


paged_decode_attention.launches = 0


# ---------------------------------------------------------------------------
# Dispatcher
# ---------------------------------------------------------------------------

def dot_product_attention(q, k, v, key_mask=None, causal=False, scale=None,
                          impl: str = "auto", train: bool = True):
    """The stock tiers by name: ``reference`` (full materialization),
    ``blockwise``, or ``flash`` (the kernel). ``auto`` takes the reference
    up to T = 1024 and the blockwise loop beyond, as the JAX package does
    off the TPU; ``use_kernels`` routing (``kernels/routing.py``), not
    this dispatcher, sends a layer to the flash kernel. ``train`` is kept
    for the layers' signature."""
    if impl == "auto":
        impl = "reference" if q.shape[2] <= 1024 else "blockwise"
    if impl == "flash":
        return flash_attention(q, k, v, key_mask, causal, scale)
    if impl == "blockwise":
        return blockwise_attention(q, k, v, key_mask, causal, scale)
    return reference_attention(q, k, v, key_mask, causal, scale)
