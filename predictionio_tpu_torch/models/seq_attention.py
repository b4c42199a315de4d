"""Self-attentive sequential recommender (SASRec-style): training and serving.

The port of ``predictionio_tpu/models/seq_attention.py``: ``SeqRecConfig``,
``build_sequences`` (numpy, copied), the transformer of ``_make_model`` as
the ``SeqRec`` module, its last-position forward (``_jitted_apply_last``'s
counterpart), ``SeqRecModel``'s batched next-item serving, and
``train_seq_rec``: Adam on the masked next-item cross-entropy, each block's
attention gradient through the flash-attention backward kernels.

Layout: histories are LEFT-padded (pad id 0, real items 1..n_items) so the
last position always holds the newest interaction; serving scores the last
hidden state against the tied item-embedding table and takes the top-N on
the host. Each block's causal attention runs through
``parallel/ring_attention.py::flash_attention``: the hand-written kernel on
a CUDA device, its plain version on the CPU.

Numerics follow the flax model: f32 parameters and residual stream;
``LayerNorm`` with epsilon 1e-6 and the fast variance E[x^2] - E[x]^2; each
``Dense`` casts its input, kernel and bias to bf16, rounds the product to
bf16 and adds the bias in bf16; attention takes f32 q, k, v; the tied
logits are a full-f32 product.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Any

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..parallel.ring_attention import flash_attention
from ..storage.bimap import BiMap

__all__ = [
    "SeqRec",
    "SeqRecConfig",
    "SeqRecModel",
    "build_sequences",
    "init_params",
    "seq_rec_loss",
    "train_seq_rec",
]


@dataclasses.dataclass(frozen=True)
class SeqRecConfig:
    max_len: int = 64
    embed_dim: int = 48
    num_heads: int = 2
    num_blocks: int = 2
    batch_size: int = 256
    epochs: int = 10
    lr: float = 1e-3
    dropout: float = 0.0  # deterministic by default; serving is always det
    seq_parallel: bool = False  # ring attention over the mesh's "seq" axis
    seed: int = 0


def build_sequences(
    users: np.ndarray,
    items: np.ndarray,
    times: np.ndarray,
    *,
    max_len: int,
    user_ids: BiMap | None = None,
    item_ids: BiMap | None = None,
) -> tuple[np.ndarray, BiMap, BiMap]:
    """Per-user, time-ordered, left-padded item sequences.

    users/items: raw string ids [n]; times: float epoch seconds [n].
    Returns (seqs [NU, max_len] int32 with 0 = pad and item index i stored
    as i+1, user BiMap, item BiMap).
    """
    if user_ids is None:
        user_ids, uidx = BiMap.from_array(np.asarray(users, dtype=object))
    else:
        uidx = user_ids.map_array(list(users))
    if item_ids is None:
        item_ids, iidx = BiMap.from_array(np.asarray(items, dtype=object))
    else:
        iidx = item_ids.map_array(list(items))
    valid = (uidx >= 0) & (iidx >= 0)
    uidx, iidx, times = uidx[valid], iidx[valid], np.asarray(times)[valid]

    nu = len(user_ids)
    seqs = np.zeros((nu, max_len), dtype=np.int32)
    order = np.lexsort((times, uidx))
    uo, io = uidx[order], iidx[order]
    starts = np.searchsorted(uo, np.arange(nu))
    ends = np.searchsorted(uo, np.arange(nu), side="right")
    for u in range(nu):
        hist = io[starts[u] : ends[u]][-max_len:] + 1  # +1: 0 is pad
        if len(hist):
            seqs[u, max_len - len(hist) :] = hist
    return seqs, user_ids, item_ids


class LayerNorm(nn.Module):
    """``flax.linen.LayerNorm()``: epsilon 1e-6, f32 statistics with the
    fast variance max(0, E[x^2] - E[x]^2), then (x - mean) * (rsqrt(var +
    eps) * scale) + bias, in flax's order."""

    def __init__(self, dim: int):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        mean = x.mean(-1, keepdim=True)
        var = torch.clamp((x * x).mean(-1, keepdim=True) - mean * mean,
                          min=0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


class Dense(nn.Module):
    """``flax.linen.Dense(out, dtype=bfloat16)``: f32 parameters with the
    kernel ``[in, out]`` as flax stores it; input, kernel and bias cast to
    bf16; the product (f32 accumulation) rounded to bf16, then the bias
    added in bf16 (two roundings, as flax does, not one fused addmm)."""

    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.kernel = nn.Parameter(torch.zeros(d_in, d_out))
        self.bias = nn.Parameter(torch.zeros(d_out))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bf16 = torch.bfloat16
        return torch.matmul(x.to(bf16), self.kernel.to(bf16)) \
            + self.bias.to(bf16)


class Block(nn.Module):
    """One pre-norm transformer block of ``_make_model``: causal
    multi-head attention, then a ReLU MLP of width 2E, each added to the
    f32 residual stream."""

    def __init__(self, dim: int, num_heads: int):
        super().__init__()
        self.num_heads = num_heads
        self.ln0, self.ln1 = LayerNorm(dim), LayerNorm(dim)
        self.qkv = Dense(dim, 3 * dim)
        self.out = Dense(dim, dim)
        self.up = Dense(dim, 2 * dim)
        self.down = Dense(2 * dim, dim)

    def forward(self, h: torch.Tensor, attention) -> torch.Tensor:
        B, L, D = h.shape
        H = self.num_heads
        qkv = self.qkv(self.ln0(h)).view(B, L, 3, H, D // H)
        # one pass to f32 that leaves q, k and v each contiguous [B, L, H, hd]
        # (a copy even where qkv is f32 already, as the kernels need it)
        q, k, v = qkv.permute(2, 0, 1, 3, 4).to(
            torch.float32, memory_format=torch.contiguous_format,
            copy=True).unbind(0)
        o = attention(q, k, v, causal=True).reshape(B, L, D)
        h = h + self.out(o).to(torch.float32)
        x = torch.relu(self.up(self.ln1(h)))
        return h + self.down(x).to(torch.float32)


class SeqRec(nn.Module):
    """The transformer of ``_make_model``: item embedding (vocab =
    n_items + 1, 0 = pad) plus the last L rows of a learned position
    table, ``num_blocks`` blocks, a final LayerNorm, logits against the
    tied embedding table."""

    def __init__(self, n_items: int, cfg: SeqRecConfig):
        super().__init__()
        vocab, dim = n_items + 1, cfg.embed_dim
        if dim % cfg.num_heads:
            raise ValueError(f"embed_dim {dim} is not a multiple of "
                             f"num_heads {cfg.num_heads}")
        self.item_embed = nn.Parameter(torch.zeros(vocab, dim))
        self.pos = nn.Parameter(torch.zeros(cfg.max_len, dim))
        self.blocks = nn.ModuleList(
            Block(dim, cfg.num_heads) for _ in range(cfg.num_blocks))
        self.ln_f = LayerNorm(dim)

    def hidden(self, seqs: torch.Tensor, attention=flash_attention):
        """The last block's output [B, L, E] f32 for histories [B, L]."""
        L = seqs.shape[1]
        h = self.item_embed[seqs.long()] + self.pos[-L:][None]
        for block in self.blocks:
            h = block(h, attention)
        return h

    def forward(self, seqs: torch.Tensor, attention=flash_attention):
        """Logits [B, L, vocab] f32, as ``_make_model(...).apply``."""
        return self.ln_f(self.hidden(seqs, attention)) @ self.item_embed.T

    def forward_last(self, seqs: torch.Tensor, attention=flash_attention):
        """Only the last position's logits [B, vocab] f32 (the counterpart
        of ``_jitted_apply_last``): LayerNorm and the tied product run on
        that row alone, which gives the same numbers row by row."""
        h = self.hidden(seqs, attention)[:, -1]
        return self.ln_f(h) @ self.item_embed.T

    @torch.no_grad()
    def load_flax(self, params) -> "SeqRec":
        """Copy the flax tree of ``_make_model(...).init`` (numpy leaves,
        with or without the top-level ``params`` key) into this module."""
        p = params.get("params", params)

        def put(dst: torch.Tensor, src) -> None:
            src = torch.as_tensor(np.asarray(src, np.float32))
            if tuple(src.shape) != tuple(dst.shape):
                raise ValueError(f"parameter shape {tuple(src.shape)}, "
                                 f"expected {tuple(dst.shape)}")
            dst.copy_(src)

        put(self.item_embed, p["item_embed"]["embedding"])
        put(self.pos, p["pos"])
        for i, block in enumerate(self.blocks):
            bp = p[f"Block_{i}"]
            for ln, name in ((block.ln0, "LayerNorm_0"),
                             (block.ln1, "LayerNorm_1")):
                put(ln.scale, bp[name]["scale"])
                put(ln.bias, bp[name]["bias"])
            for j, dense in enumerate((block.qkv, block.out, block.up,
                                       block.down)):
                put(dense.kernel, bp[f"Dense_{j}"]["kernel"])
                put(dense.bias, bp[f"Dense_{j}"]["bias"])
        put(self.ln_f.scale, p["LayerNorm_0"]["scale"])
        put(self.ln_f.bias, p["LayerNorm_0"]["bias"])
        return self

    @torch.no_grad()
    def to_flax(self) -> dict:
        """This module's weights as the flax tree ``load_flax`` reads
        (``{"params": ...}``, numpy f32 leaves): the form serving,
        ``convert`` and model blobs keep."""
        def get(t: torch.Tensor) -> np.ndarray:
            return t.detach().to("cpu", torch.float32).numpy().copy()

        def ln(m: LayerNorm) -> dict:
            return {"scale": get(m.scale), "bias": get(m.bias)}

        p: dict = {"item_embed": {"embedding": get(self.item_embed)},
                   "pos": get(self.pos)}
        for i, block in enumerate(self.blocks):
            p[f"Block_{i}"] = {"LayerNorm_0": ln(block.ln0),
                               "LayerNorm_1": ln(block.ln1)} | {
                f"Dense_{j}": {"kernel": get(d.kernel), "bias": get(d.bias)}
                for j, d in enumerate((block.qkv, block.out, block.up,
                                       block.down))}
        p["LayerNorm_0"] = ln(self.ln_f)
        return {"params": p}


def init_params(n_items: int, cfg: SeqRecConfig, seed: int) -> dict:
    """A flax-named parameter tree (numpy f32 leaves) drawn from a seeded
    numpy generator at flax's init scales: normal(0.02) item embeddings
    and positions, LayerNorm scale 1 / bias 0, Dense kernels lecun-normal
    (a normal truncated at two standard deviations, variance 1 / fan_in)
    and zero biases. Not ``jax.random``'s numbers: the same seed gives
    other weights than the JAX trainer's init."""
    rng = np.random.default_rng(seed)
    dim = cfg.embed_dim

    def normal(shape, std):
        return (rng.standard_normal(shape, np.float32) * std).astype(
            np.float32)

    def lecun(d_in, d_out):
        x = rng.standard_normal((d_in, d_out), np.float32)
        out = np.abs(x) > 2
        while out.any():  # redraw outside [-2, 2]
            x[out] = rng.standard_normal(int(out.sum()), np.float32)
            out = np.abs(x) > 2
        # 0.8796...: the std of a unit normal truncated at +-2
        return (x * (np.sqrt(1.0 / d_in) / 0.87962566103423978)).astype(
            np.float32)

    def ln():
        return {"scale": np.ones(dim, np.float32),
                "bias": np.zeros(dim, np.float32)}

    p: dict = {"item_embed": {"embedding": normal((n_items + 1, dim), 0.02)},
               "pos": normal((cfg.max_len, dim), 0.02)}
    widths = ((dim, 3 * dim), (dim, dim), (dim, 2 * dim), (2 * dim, dim))
    for i in range(cfg.num_blocks):
        p[f"Block_{i}"] = {"LayerNorm_0": ln(), "LayerNorm_1": ln()} | {
            f"Dense_{j}": {"kernel": lecun(a, b),
                           "bias": np.zeros(b, np.float32)}
            for j, (a, b) in enumerate(widths)}
    p["LayerNorm_0"] = ln()
    return {"params": p}


def _pad_batch(b: int) -> int:
    """The batch padded to a power of two >= 8, as the JAX model pads it."""
    b_pad = 8
    while b_pad < b:
        b_pad *= 2
    return b_pad


@dataclasses.dataclass
class SeqRecModel:
    params: Any  # the flax tree, numpy leaves
    seqs: np.ndarray  # [NU, L] training-time histories for serving
    user_ids: BiMap
    item_ids: BiMap
    config: SeqRecConfig

    #: forward-pass cap for batched serving/eval: bounds the device
    #: [chunk, L, d] activations and the [chunk, vocab] logits pull
    BATCH_CHUNK = 256

    def __post_init__(self):
        # one forward at a time: concurrent forwards would queue on the
        # same stream anyway, each holding its [b_pad, L, E] activations
        self._lock = threading.Lock()
        #: forward passes run (prewarm included); each launches the
        #: attention kernel once per block on a CUDA device
        self.forwards = 0

    def attach_model(self, device=None) -> None:
        """Build the module from ``params`` on ``device`` (``None`` means
        CUDA) and serve from it; the weights stay there from now on."""
        dev = resolve_device(device)
        net = SeqRec(len(self.item_ids), self.config).load_flax(self.params)
        self._net = net.to(dev).eval().requires_grad_(False)

    @property
    def device(self) -> torch.device | None:
        net = getattr(self, "_net", None)
        return None if net is None else net.item_embed.device

    def logits_last(self, seqs: np.ndarray) -> np.ndarray:
        """Host f32 [B, vocab] last-position logits of histories [B, L];
        only that row of logits leaves the device."""
        if getattr(self, "_net", None) is None:
            self.attach_model()
        net = self._net
        with self._lock, torch.inference_mode():
            x = torch.from_numpy(np.ascontiguousarray(seqs, np.int32))
            out = net.forward_last(x.to(net.item_embed.device)).cpu().numpy()
            self.forwards += 1
        return out

    def prewarm(self, batch_sizes=(1,)) -> list[int]:
        """Run the forward once per distinct padded batch of
        ``batch_sizes``, so no query pays the kernel build or a first
        launch. Returns the b_pad values warmed."""
        warmed: list[int] = []
        for b in batch_sizes:
            b_pad = _pad_batch(b)
            if b <= 0 or b_pad in warmed:
                continue
            self.logits_last(np.zeros((b_pad, self.seqs.shape[1]), np.int32))
            warmed.append(b_pad)
        return warmed

    def recommend_products(
        self, user_id: str, num: int, *, exclude_seen: bool = True
    ) -> list[tuple[str, float]]:
        return self.batch_recommend([user_id], [num],
                                    exclude_seen=exclude_seen)[0]

    def batch_recommend(
        self, users: list, nums: list, *, exclude_seen: bool = True
    ) -> list[list[tuple[str, float]]]:
        """Per-user next-item top-N, one forward pass per <=BATCH_CHUNK
        queries ([B, L] histories stacked, batch padded to a power of two
        so traffic-dependent sizes reuse a handful of shapes; only the
        last position's [B, vocab] logits leave the device). Seen items
        are masked and the top-N taken on the host. Unknown users get
        []."""
        out: list = [[] for _ in users]
        known = [(j, self.user_ids.get(u)) for j, u in enumerate(users)]
        known = [(j, r) for j, r in known if r is not None]
        if not known:
            return out
        inv = self.item_ids.inverse
        for start in range(0, len(known), self.BATCH_CHUNK):
            part = known[start:start + self.BATCH_CHUNK]
            rows = [r for _, r in part]
            seqs = self.seqs[rows]  # [B, L]
            b = len(rows)
            b_pad = _pad_batch(b)
            fed = np.pad(seqs, ((0, b_pad - b), (0, 0))) if b_pad != b else seqs
            logits = self.logits_last(fed)[:b, 1:]  # [B, vocab-1], no pad id
            for (j, _row), seq, row_scores in zip(part, seqs, logits):
                scores = row_scores
                if exclude_seen:
                    seen = seq[seq > 0] - 1
                    scores = scores.copy()
                    scores[seen] = -np.inf
                num = min(max(nums[j], 0), int(np.isfinite(scores).sum()))
                if num <= 0:
                    continue
                top = np.argpartition(-scores, num - 1)[:num]
                top = top[np.argsort(-scores[top])]
                out[j] = [(inv[int(i)], float(scores[i])) for i in top]
        return out

    def __getstate__(self):
        state = dict(self.__dict__)
        # the device module and the lock never enter a model blob
        state.pop("_net", None)
        state.pop("_lock", None)
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self._lock = threading.Lock()


_default_init = init_params


def seq_rec_loss(net: SeqRec, batch: torch.Tensor,
                 attention=flash_attention) -> torch.Tensor:
    """The trainer's loss on histories ``batch [B, max_len]``: the model on
    ``batch[:, :-1]``, softmax cross-entropy against ``batch[:, 1:]``, pad
    targets (0) masked, averaged over the real targets (``loss_fn`` of the
    JAX trainer)."""
    inp, tgt = batch[:, :-1], batch[:, 1:].long()
    logits = net(inp, attention)  # [B, L-1, vocab]
    ce = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tgt.reshape(-1),
        reduction="none")
    mask = (tgt.reshape(-1) > 0).to(torch.float32)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def train_seq_rec(seqs: np.ndarray, user_ids: BiMap, item_ids: BiMap,
                  cfg: SeqRecConfig, *, device=None,
                  init_params=None) -> SeqRecModel:
    """Next-item prediction over left-padded histories ``seqs [users,
    max_len]`` on one device (``None`` means CUDA; raises without one). The
    port of the JAX trainer: weights from ``init_params`` (a flax-named
    tree, default ``init_params(n_items, cfg, cfg.seed)``; the JAX trainer
    draws its init with ``jax.random``, which torch cannot reproduce, so a
    caller that wants its numbers passes that tree), ``torch.optim.Adam``
    with optax.adam's defaults, the masked-mean next-item cross-entropy,
    users with an empty history dropped, batches of ``min(batch_size,
    users)`` with the tail batch wrapping, and every epoch reshuffled by a
    ``torch.Generator`` seeded from ``cfg.seed`` and staged on the device
    as one ``[n_batches, bs, max_len]`` tensor. ``seq_parallel`` changes
    nothing on one device. Returns a ``SeqRecModel`` with the trained
    flax-named ``params``, attached to the device."""
    dev = resolve_device(device)
    n_items = len(item_ids)
    tree = (init_params if init_params is not None
            else _default_init(n_items, cfg, cfg.seed))
    net = SeqRec(n_items, cfg).load_flax(tree).to(dev)
    opt = torch.optim.Adam(net.parameters(), lr=cfg.lr, betas=(0.9, 0.999),
                           eps=1e-8)
    seqs = np.ascontiguousarray(seqs, np.int32)
    active = np.nonzero((seqs > 0).any(axis=1))[0]
    n = len(active)
    bs = min(cfg.batch_size, max(1, n))
    n_batches = -(-n // bs)  # the tail batch wraps so no user is dropped
    gen = torch.Generator().manual_seed(cfg.seed)
    for _ep in range(cfg.epochs if n else 0):
        order = torch.randperm(n, generator=gen).numpy()
        idx = order[np.arange(n_batches * bs) % n]
        batches = torch.from_numpy(
            seqs[active[idx]].reshape(n_batches, bs, -1)).to(dev)
        for batch in batches:
            opt.zero_grad(set_to_none=True)
            seq_rec_loss(net, batch).backward()
            opt.step()
    model = SeqRecModel(params=net.to_flax(), seqs=seqs, user_ids=user_ids,
                        item_ids=item_ids, config=cfg)
    model.attach_model(dev)
    return model
