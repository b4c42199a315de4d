"""Carry trained weights and training inputs into the port.

A model trained elsewhere (the JAX package's ALS or seqrec, for one)
reaches the port as plain arrays and id lists; so does the device state
of an ALS training run (the layout's numpy arrays and a true-row-order
init). Nothing here touches the object that produced them.
"""

from __future__ import annotations

import numpy as np

from .models.als import ALSConfig, ALSModel, put_layout, to_slots
from .models.seq_attention import SeqRecConfig, SeqRecModel
from .storage.bimap import BiMap

__all__ = ["als_model_from_numpy", "als_train_state_from_numpy",
           "seqrec_model_from_numpy"]


def als_model_from_numpy(user_factors, item_factors, user_ids, item_ids, *,
                         rank: int, lambda_: float,
                         implicit_prefs: bool = False, alpha: float = 1.0,
                         device=None) -> ALSModel:
    """The port's ``ALSModel`` from f32 factor arrays and the str ids of
    their rows, in row order, with its catalog attached to a retriever on
    ``device`` (``None`` means CUDA; a server that deploys the model
    attaches it again on its own device)."""
    uf = np.ascontiguousarray(user_factors, np.float32)
    vf = np.ascontiguousarray(item_factors, np.float32)
    if uf.ndim != 2 or vf.ndim != 2 or uf.shape[1] != rank \
            or vf.shape[1] != rank:
        raise ValueError(f"factors must be [rows, {rank}]; got {uf.shape} "
                         f"and {vf.shape}")
    if len(user_ids) != len(uf) or len(item_ids) != len(vf):
        raise ValueError("one id per factor row is required")
    model = ALSModel(
        user_factors=uf, item_factors=vf,
        user_ids=BiMap({str(u): i for i, u in enumerate(user_ids)}),
        item_ids=BiMap({str(v): i for i, v in enumerate(item_ids)}),
        config=ALSConfig(rank=rank, lambda_=lambda_,
                         implicit_prefs=implicit_prefs, alpha=alpha))
    model.attach_retriever(device=device)
    return model


def als_train_state_from_numpy(u_layout, i_layout, u0, v0, *, device=None,
                               vals_dtype=None):
    """The device state ``make_train_step`` runs on, from host arrays:
    ``(u_buckets, i_buckets, u_perm, v_perm)``. ``u_layout`` / ``i_layout``
    are the two sides of ``build_bilinear_layout`` (the port's, or the JAX
    package's: only their numpy arrays are read); ``u0`` / ``v0`` are
    true-row-order factors [rows, R], permuted into slot order with every
    slot no row owns left exactly zero. ``vals_dtype="bfloat16"`` is the
    bf16 compute path's upload. ``device`` None means CUDA."""
    return (put_layout(u_layout, device, vals_dtype=vals_dtype),
            put_layout(i_layout, device, vals_dtype=vals_dtype),
            to_slots(u0, u_layout, device), to_slots(v0, i_layout, device))


def seqrec_model_from_numpy(params, seqs, user_ids, item_ids,
                            config: SeqRecConfig, *,
                            device=None) -> SeqRecModel:
    """The port's ``SeqRecModel`` from the flax parameter tree of the JAX
    seqrec model (numpy leaves, as ``train_seq_rec`` returns them), the
    left-padded histories ``seqs [users, max_len]`` (0 = pad, item row i
    stored as i + 1) and the str ids of the user and item rows, in row
    order. Its module is built on ``device`` (``None`` means CUDA; a
    server that deploys the model attaches it again on its own device)."""
    seqs = np.ascontiguousarray(seqs, np.int32)
    if seqs.ndim != 2 or seqs.shape[1] != config.max_len:
        raise ValueError(f"seqs must be [users, {config.max_len}]; got "
                         f"{seqs.shape}")
    if len(user_ids) != len(seqs):
        raise ValueError("one user id per history row is required")
    if seqs.size and (seqs.min() < 0 or seqs.max() > len(item_ids)):
        raise ValueError(f"history ids must lie in [0, {len(item_ids)}]")
    model = SeqRecModel(
        params=params, seqs=seqs,
        user_ids=BiMap({str(u): i for i, u in enumerate(user_ids)}),
        item_ids=BiMap({str(v): i for i, v in enumerate(item_ids)}),
        config=config)
    model.attach_model(device=device)
    return model
