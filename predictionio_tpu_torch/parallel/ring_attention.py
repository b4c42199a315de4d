"""Single-device flash-style attention: the plain versions and the kernels.

The port of ``predictionio_tpu/parallel/ring_attention.py``'s one-device
half, and of the ``jax.custom_vjp`` around jax's stock Pallas TPU kernel
that its ``flash_attention`` calls. ``blockwise_attention`` is the plain
PyTorch version of the hand-written forward kernel ``csrc/flash_attn.cu``:
the same [B, L, H, D] contract, matmuls in the input type (bf16 for bf16
inputs, else f32) with f32 accumulation, f32 softmax carries folded block
by block (``_merge_carry``), a padded and masked tail block, and the output
in ``q.dtype``; asked for it, it also returns each row's logsumexp.
``blockwise_attention_bwd`` is the plain version of the backward kernels
``csrc/flash_attn_bwd.cu`` (dK/dV and dQ), from that logsumexp.

``flash_attention`` is the entry point the seqrec model calls. The kernels
take head dims that are multiples of 8 up to 128, and 256; any other head
dim up to 256 is zero-padded along the features to the next of those
(``_pad_features``: 10 to 16, 136 to 256), the kernels run with the scale
1/sqrt(D) of the original D, and the output and gradients are sliced back
to D. That is exact: zero features add exact zeros to Q K^T, the padded
output columns are P times zeros, and the logsumexp and
``di = rowsum(do * o)`` are unchanged. Without gradients (serving,
``torch.inference_mode``) it launches the forward kernel on a CUDA tensor
and runs ``blockwise_attention`` on a CPU tensor. When grad is enabled and
an input requires it, it goes through ``FlashAttention``, the
``torch.autograd.Function`` that takes the ``custom_vjp``'s place: its
forward also writes the logsumexp, its backward computes ``di`` and
launches the dK/dV and dQ kernels (the plain versions on a CPU tensor, so
the CPU runs the same padding and wiring). On a CUDA tensor a head dim
above 256, or a dtype other than f32 and bf16, raises in the kernel
wrappers before any launch.

Ring and Ulysses attention (``ppermute`` / ``all_to_all`` over a ``seq``
mesh axis) come with the ``torch.distributed`` slice.
"""

from __future__ import annotations

import torch

from ..ops import kernels

__all__ = ["FlashAttention", "attention_di", "blockwise_attention",
           "blockwise_attention_bwd", "flash_attention"]

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


def _block_mask(L: int, L_pad: int, bs: int, i: int, causal: bool, dev):
    """The [L, bs] visibility of key block ``i`` (padded keys and, under
    ``causal``, keys after the query), or None when every key is visible."""
    k_pos = i * bs + torch.arange(bs, device=dev)
    mask = None
    if L_pad != L:
        mask = (k_pos < L)[None, :].expand(L, bs)
    if causal:
        cm = k_pos[None, :] <= torch.arange(L, device=dev)[:, None]
        mask = cm if mask is None else mask & cm
    return mask


def blockwise_attention(q, k, v, *, causal: bool = False,
                        block_size: int = 1024, return_lse: bool = False,
                        scale: float | None = None):
    """Flash-style blockwise attention over K/V chunks, one device.
    q, k, v: [B, L, H, D]; returns q.dtype. The kernel's plain version.
    With ``return_lse`` it returns ``(out, lse)``, lse [B, H, L] f32 the
    logsumexp m + log(l) of each row's scaled scores, from the carries.
    ``scale`` multiplies the scores, 1/sqrt(D) by default."""
    B, L, H, D = q.shape
    f32 = torch.float32
    scale = 1.0 / (D**0.5) if scale is None else scale
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
    m = torch.full((B, H, L), _NEG, dtype=f32, device=dev)
    acc = torch.zeros((B, H, L, D), dtype=f32, device=dev)
    l = torch.zeros((B, H, L), dtype=f32, device=dev)  # noqa: E741
    for i in range(nblk):
        k_blk = kt[:, :, i * bs:(i + 1) * bs]
        v_blk = vt[:, :, i * bs:(i + 1) * bs]
        mask = _block_mask(L, L_pad, bs, i, causal, dev)
        bm, pv, bl = _block_attn_bhld(qt, k_blk, v_blk, scale, mask,
                                      mm_dtype)
        m, acc, l = _merge_carry(m, acc, l, bm, pv, bl)  # noqa: E741
    out = acc / torch.clamp(l, min=1e-20)[..., None]
    out = out.transpose(1, 2).to(q.dtype)
    if return_lse:
        # every row sees a key (key 0 under the causal mask): l > 0
        return out, m + torch.log(l)
    return out


def attention_di(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """``di = rowsum(do * o)`` [B, H, L] f32 (contiguous) of [B, L, H, D]
    tensors: the backward's row term, as the ``custom_vjp`` computes it
    outside the kernels."""
    return (o.float() * do.float()).sum(-1).transpose(1, 2).contiguous()


def blockwise_attention_bwd(q, k, v, o, lse, do, *, causal: bool = False,
                            block_size: int = 1024,
                            scale: float | None = None):
    """(dq, dk, dv) of ``blockwise_attention`` for the output gradient
    ``do``: the plain version of the backward kernels. q, k, v, o, do:
    [B, L, H, D]; lse: [B, H, L] f32 from the forward. Key block by key
    block: P = exp(S - lse) masked to exact zeros, dV += P^T dO,
    dP = dO V^T, dS = ((dP - di) * P) * scale, dK = dS^T Q, dQ += dS K.
    Products of ``mm_dtype`` values summed in f32; for bf16 inputs P and dS
    are rounded to bf16 before the products they feed (dS from the
    unrounded P), as the kernels do. The kernels form P as ``exp2`` of
    (S * scale - lse) * log2(e) and sum in another order, so their f32
    gradients differ from these in the last bits. ``scale`` is the
    forward's, 1/sqrt(D) by default. Returns q.dtype tensors."""
    B, L, H, D = q.shape
    f32 = torch.float32
    scale = 1.0 / (D**0.5) if scale is None else scale
    bs = min(block_size, L)
    nblk = (L + bs - 1) // bs
    L_pad = nblk * bs
    mm_dtype = q.dtype if q.dtype == torch.bfloat16 else f32

    def bhld(x):
        return x.transpose(1, 2).to(mm_dtype).to(f32)

    qt, kt, vt, dot = bhld(q), bhld(k), bhld(v), bhld(do)
    if L_pad != L:
        kt = torch.nn.functional.pad(kt, (0, 0, 0, L_pad - L))
        vt = torch.nn.functional.pad(vt, (0, 0, 0, L_pad - L))
    di = attention_di(o, do)[..., None]
    lse = lse[..., None]
    dq = torch.zeros((B, H, L, D), dtype=f32, device=q.device)
    dk = torch.zeros((B, H, L_pad, D), dtype=f32, device=q.device)
    dv = torch.zeros((B, H, L_pad, D), dtype=f32, device=q.device)
    zero = torch.zeros((), dtype=f32, device=q.device)
    for i in range(nblk):
        blk = slice(i * bs, (i + 1) * bs)
        k_blk, v_blk = kt[:, :, blk], vt[:, :, blk]
        mask = _block_mask(L, L_pad, bs, i, causal, q.device)
        s = torch.matmul(qt, k_blk.transpose(-1, -2)) * scale
        p = torch.exp(s - lse)
        if mask is not None:
            p = torch.where(mask[None, None], p, zero)
        pr = p.to(mm_dtype).to(f32)
        dv[:, :, blk] = torch.matmul(pr.transpose(-1, -2), dot)
        dp = torch.matmul(dot, v_blk.transpose(-1, -2))
        ds = ((dp - di) * p * scale).to(mm_dtype).to(f32)
        dk[:, :, blk] = torch.matmul(ds.transpose(-1, -2), qt)
        dq += torch.matmul(ds, k_blk)

    def back(x):
        return x[:, :, :L].transpose(1, 2).to(q.dtype)

    return back(dq), back(dk), back(dv)


def _pad_features(*xs: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """[B, L, H, D] tensors zero-padded along D to the next head dim the
    kernels take (a multiple of 8 up to 128, else 256), or the same tensors
    when D is one already or above 256."""
    D = xs[0].shape[-1]
    pad = -D % 8 if D <= 128 else 256 - D if D <= 256 else 0
    if not pad:
        return xs
    return tuple(torch.nn.functional.pad(x, (0, pad)) for x in xs)


class FlashAttention(torch.autograd.Function):
    """Exact attention with the kernels' backward: the counterpart of the
    ``jax.custom_vjp`` around jax's Pallas TPU flash kernel. The forward
    pads the features to a head dim the kernels take and saves the padded
    q, k, v, o and the logsumexp; the backward pads the output gradient
    alike, computes ``di`` and runs the dK/dV and dQ kernels on CUDA
    tensors, the plain versions on CPU tensors (so the CPU exercises the
    same wiring), then slices the gradients back to D."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, block_size: int):
        D = q.shape[-1]
        ctx.causal, ctx.block_size = causal, block_size
        ctx.scale = 1.0 / (D**0.5)
        q, k, v = _pad_features(q, k, v)
        if q.device.type == "cpu":
            o, lse = blockwise_attention(q, k, v, causal=causal,
                                         block_size=block_size,
                                         return_lse=True, scale=ctx.scale)
        else:
            B, L, H, _ = q.shape
            lse = torch.empty((B, H, L), dtype=torch.float32,
                              device=q.device)
            o = kernels.flash_attention_fwd(q, k, v, causal=causal, lse=lse,
                                            scale=ctx.scale)
        ctx.save_for_backward(q, k, v, o, lse)
        return o if o.shape[-1] == D else o[..., :D]

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        D = do.shape[-1]
        do = do.contiguous()
        if o.shape[-1] != D:
            (do,) = _pad_features(do)
        if q.device.type == "cpu":
            dq, dk, dv = blockwise_attention_bwd(
                q, k, v, o, lse, do, causal=ctx.causal,
                block_size=ctx.block_size, scale=ctx.scale)
        else:
            di = attention_di(o, do)
            dk, dv = kernels.flash_attention_bwd_dkv(
                q, k, v, do, lse, di, causal=ctx.causal, scale=ctx.scale)
            dq = kernels.flash_attention_bwd_dq(
                q, k, v, do, lse, di, causal=ctx.causal, scale=ctx.scale)
        if o.shape[-1] != D:
            dq, dk, dv = dq[..., :D], dk[..., :D], dv[..., :D]
        return dq, dk, dv, None, None


def flash_attention(q, k, v, *, causal: bool = False,
                    block_size: int = 1024):
    """Exact attention for [B, L, H, D] and any L >= 1: the hand-written
    kernels on a CUDA tensor (f32 or bf16, any head dim up to 256, padded to
    one the kernels take), their plain versions on a CPU tensor (any head
    dim). Under autograd (grad enabled and an input that requires it) it
    runs ``FlashAttention``, whose backward is the dK/dV and dQ kernels.
    ``block_size`` is the plain versions'; the kernels tile themselves."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, block_size)
    D = q.shape[-1]
    scale = 1.0 / (D**0.5)
    qp, kp, vp = _pad_features(q, k, v)
    if q.device.type == "cpu":
        o = blockwise_attention(qp, kp, vp, causal=causal,
                                block_size=block_size, scale=scale)
    else:
        o = kernels.flash_attention_fwd(qp, kp, vp, causal=causal,
                                        scale=scale)
    return o if o.shape[-1] == D else o[..., :D]
