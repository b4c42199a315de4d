"""Single-device flash-style attention: the plain version and the kernel.

The port of ``predictionio_tpu/parallel/ring_attention.py``'s one-device
half. ``blockwise_attention`` is the plain PyTorch version of the
hand-written kernel ``csrc/flash_attn.cu``: the same [B, L, H, D] contract,
matmuls in the input type (bf16 for bf16 inputs, else f32) with f32
accumulation, f32 softmax carries folded block by block
(``_merge_carry``), a padded and masked tail block, and the output in
``q.dtype``. ``flash_attention`` is the entry point the seqrec model
calls: on a CUDA tensor it launches the kernel (``ops/kernels.py``) for
every shape the kernel takes, and raises on the others; on a CPU tensor it
runs ``blockwise_attention``.

Ring and Ulysses attention (``ppermute`` / ``all_to_all`` over a ``seq``
mesh axis) come with the ``torch.distributed`` slice.
"""

from __future__ import annotations

import torch

from ..ops import kernels

__all__ = ["blockwise_attention", "flash_attention"]

_NEG = -1e30


def _merge_carry(m, acc, l, bm, pv, bl):  # noqa: E741 - l is the flash sum
    """Fold one block's (bm, pv, bl) into the running flash-softmax carry
    (m, acc, l): rescale both sides to the new running max, guarding
    never-touched rows (m = _NEG) against exp(_NEG - _NEG) = 1."""
    m_new = torch.maximum(m, bm)
    zero = torch.zeros((), dtype=m.dtype, device=m.device)
    alpha = torch.exp(torch.where(m > _NEG / 2, m - m_new, zero))
    beta = torch.exp(torch.where(bm > _NEG / 2, bm - m_new, zero))
    acc = acc * alpha[..., None] + pv * beta[..., None]
    return m_new, acc, l * alpha + bl * beta


def _block_attn_bhld(qt, k_blk, v_blk, scale, mask, mm_dtype):
    """One [Lq, Lk] score block in [B, H, L, D] layout -> (scores_max,
    exp-weights @ v, exp-sum): m [B, H, Lq], pv [B, H, Lq, D] f32,
    l [B, H, Lq] f32. The operands hold ``mm_dtype`` values; each product
    is formed and summed in f32 (a bf16 x bf16 product is exact in f32),
    which is ``preferred_element_type=f32``. P is rounded to ``mm_dtype``
    before P @ V; the sum uses the unrounded P."""
    f32 = torch.float32
    s = torch.matmul(qt.to(f32), k_blk.to(f32).transpose(-1, -2)) * scale
    if mask is not None:
        s = torch.where(mask[None, None], s,
                        torch.full((), _NEG, dtype=f32, device=s.device))
    m = s.amax(-1)  # [B, H, Lq]
    # fully-masked rows: keep them at exp(_NEG) ~ 0, not exp(0)
    base = torch.where(m > _NEG / 2, m, torch.zeros((), dtype=f32,
                                                     device=m.device))
    p = torch.exp(s - base[..., None])
    l = p.sum(-1)  # noqa: E741
    pv = torch.matmul(p.to(mm_dtype).to(f32), v_blk.to(f32))
    return m, pv, l


def blockwise_attention(q, k, v, *, causal: bool = False,
                        block_size: int = 1024):
    """Flash-style blockwise attention over K/V chunks, one device.
    q, k, v: [B, L, H, D]; returns q.dtype. The kernel's plain version."""
    B, L, H, D = q.shape
    f32 = torch.float32
    scale = 1.0 / (D**0.5)
    bs = min(block_size, L)
    nblk = (L + bs - 1) // bs
    L_pad = nblk * bs
    mm_dtype = q.dtype if q.dtype == torch.bfloat16 else f32
    qt = q.transpose(1, 2).to(mm_dtype)
    kt = k.transpose(1, 2).to(mm_dtype)
    vt = v.transpose(1, 2).to(mm_dtype)
    if L_pad != L:
        # pad K/V to whole blocks; padded keys are masked out below
        kt = torch.nn.functional.pad(kt, (0, 0, 0, L_pad - L))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, L_pad - L))
    dev = q.device
    q_pos = torch.arange(L, device=dev)
    m = torch.full((B, H, L), _NEG, dtype=f32, device=dev)
    acc = torch.zeros((B, H, L, D), dtype=f32, device=dev)
    l = torch.zeros((B, H, L), dtype=f32, device=dev)  # noqa: E741
    for i in range(nblk):
        k_blk = kt[:, :, i * bs:(i + 1) * bs]
        v_blk = vt[:, :, i * bs:(i + 1) * bs]
        k_pos = i * bs + torch.arange(bs, device=dev)
        mask = None
        if L_pad != L:
            mask = (k_pos < L)[None, :].expand(L, bs)
        if causal:
            cm = k_pos[None, :] <= q_pos[:, None]
            mask = cm if mask is None else mask & cm
        bm, pv, bl = _block_attn_bhld(qt, k_blk, v_blk, scale, mask,
                                      mm_dtype)
        m, acc, l = _merge_carry(m, acc, l, bm, pv, bl)  # noqa: E741
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    return out.transpose(1, 2).to(q.dtype)


def flash_attention(q, k, v, *, causal: bool = False,
                    block_size: int = 1024):
    """Exact attention for [B, L, H, D]: the hand-written kernel on a CUDA
    tensor (any L >= 1, head dim a multiple of 8 up to 128, f32 or bf16;
    other shapes raise), ``blockwise_attention`` on a CPU tensor.
    ``block_size`` is the plain version's; the kernel tiles itself."""
    if q.device.type == "cpu":
        return blockwise_attention(q, k, v, causal=causal,
                                   block_size=block_size)
    return kernels.flash_attention_fwd(q, k, v, causal=causal)
