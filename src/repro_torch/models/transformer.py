"""Decoder stack — the port's copy of ``repro/models/transformer.py``,
for the dense, MoE, SSM, hybrid and VLM families (the encoder-decoder
family is :mod:`repro_torch.models.encdec`).

``params["blocks"]`` and the decode caches are lists of per-block dicts
(the reference stacks them on a leading axis and scans); a block's
sublayers are ``sub0``, ``sub1``, ... as in the reference
(:func:`block_spec`: one attention or Mamba mixer each, then a dense or
MoE FFN, or none).  Each block's matmul weights are cast to the compute
type as the block runs, as the reference does
(``cast_params_for_compute``); weights made with ``init_params(...,
cast_blocks=True)`` are already of that type, so the cast is a no-op
and the numbers are the same (serving only: training differentiates
the f32 masters).

``tp`` pads the heads and the vocabulary as the reference does
(``padded_heads``/``padded_vocab``) and splits each expert into
``tpe = tp // E`` slices where there are fewer experts than ``tp``;
without a mesh such a model runs whole on one rank, equal to the
reference's mesh-free ``build(cfg, tp)``.  On a mesh
(:mod:`repro_torch.parallel`; the params, caches, tokens and logits are
this rank's blocks, as ``sharding`` lays them out) the attention and
the dense FFN are tensor-parallel over "model"
(:mod:`repro_torch.models.attention`, ``layers.swiglu``), the
embedding and the logits vocab-parallel, the MoE FFN in the mode
``moe_mode`` names (``a2a`` at prefill and in training, ``psum`` at
decode, or the two-axis ``ep2`` for a ``moe_ep_data`` config), the
decode caches' slots sharded over "model" and their rows over the batch
axes; each block's weights are all-gathered over "data" under the
rules' ``fsdp``.  A Mamba mixer splits its SSD heads over "model"
(:func:`~repro_torch.models.ssm.mamba_forward_mesh`: the reference's
contiguous split of ``in_proj``'s packed output all-gathered, each rank
taking its heads), so their count must divide by the axis's size.

Training (:func:`train_loss`): with ``cfg.remat`` each block, the cast
of its f32 masters included, runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference wraps its scanned block in
``jax.checkpoint``: only the block's input is kept, and the backward
runs the block again (K4 included).  ``remat_policy="dots"`` keeps the
matmul outputs (``aten.mm``/``bmm``: the reference's
``dots_with_no_batch_dims_saveable``) through a selective-checkpoint
context; ``"nothing"`` keeps none.

Training on a mesh (``train_loss`` with the rules installed, ``moe_mode``
``a2a``): the same forward under autograd, every collective with its
adjoint (:mod:`repro_torch.parallel.collectives`); the tensor-parallel
boundaries of :mod:`repro_torch.models.layers`; the loss vocab-parallel.
Under the rules' ``sp_rs`` (:func:`~repro_torch.models.layers.
use_sp_rs` of the sequence) the residual is sequence-sharded over
"model" from the embedding's reduce-scatter to the loss's all-gather,
as the reference lays it out.  A block's ``fsdp_gather`` runs inside
its :func:`remat` region, so its whole weights are not kept and the
recompute gathers them again: every rank recomputes the same blocks in
the same order, since every rank runs the same backward graph.  The
loss is the global mean on every rank; the gradients of weights
replicated over the batch axes are partial until
:func:`~repro_torch.parallel.sharding.sync_grads` sums them.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models import ssm as ssm_mod
from repro_torch.models.embedding import embed_tokens, lm_logits, lm_loss
from repro_torch.models.layers import (cast_params_for_compute, dense_init,
                                       filled, fsdp_gather, norm, rms_norm,
                                       split_keys, swiglu, use_sp_rs)
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import (current_fsdp, current_mesh,
                                       current_rules, model_size)
from repro_torch.tree import leaves

# --------------------------------------------------------------------------
# block structure
# --------------------------------------------------------------------------

def block_spec(cfg: ModelConfig) -> list[tuple[str, str | None]]:
    """Sublayers of one block: (mixer, ffn) kinds."""
    if cfg.family == "ssm":
        return [("mamba", None)]
    if cfg.family == "hybrid":
        out = []
        for i in range(cfg.attn_every):
            mixer = "attn" if i == 0 else "mamba"
            ffn = "moe" if (i % cfg.moe_every == 1) else "dense"
            out.append((mixer, ffn))
        return out
    ffn = "moe" if cfg.family == "moe" else "dense"
    return [("attn", ffn)]


def n_blocks(cfg: ModelConfig) -> int:
    return max(1, cfg.n_layers // len(block_spec(cfg)))


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_ffn(key, cfg, dtype):
    ks = split_keys(key, 3)
    return {
        "wg": dense_init(ks[0], (cfg.d_model, cfg.d_ff), dtype),
        "wi": dense_init(ks[1], (cfg.d_model, cfg.d_ff), dtype),
        "wo": dense_init(ks[2], (cfg.d_ff, cfg.d_model), dtype,
                         fan_in=cfg.d_ff),
    }


def _init_block(key, cfg: ModelConfig, tp: int):
    nh, nkv = cfg.padded_heads(tp)
    tpe = (cfg.moe_tpe or max(1, tp // cfg.n_experts)) \
        if cfg.n_experts else 1
    dtype = cfg.param_dtype
    subs = {}
    keys = split_keys(key, len(block_spec(cfg)))
    for j, (mixer, ffn) in enumerate(block_spec(cfg)):
        ks = split_keys(keys[j], 2)
        sub: dict[str, Any] = {"ln1": filled((cfg.d_model,), 1.0, key)}
        if mixer == "attn":
            sub["attn"] = attn_mod.init_attention(
                ks[0], cfg.d_model, nh, nkv, cfg.head_dim, dtype)
        else:
            sub["mamba"] = ssm_mod.init_mamba(
                ks[0], cfg.d_model, cfg.ssm_state, cfg.ssm_head_dim,
                cfg.ssm_expand, cfg.ssm_conv, dtype)
        if ffn is not None:
            sub["ln2"] = filled((cfg.d_model,), 1.0, key)
            if ffn == "moe":
                sub["moe"] = moe_mod.init_moe(
                    ks[1], cfg.d_model, cfg.d_ff, cfg.n_experts, dtype,
                    tpe=tpe)
            else:
                sub["ffn"] = _init_ffn(ks[1], cfg, dtype)
        subs[f"sub{j}"] = sub
    return subs


def init_params(cfg: ModelConfig, key: torch.Generator | None, tp: int = 1,
                *, cast_blocks: bool = False):
    """Weights drawn from ``key`` on its device (``None``: shapes only,
    on the ``meta`` device).  ``cast_blocks`` casts each block's matmul
    weights to ``cfg.compute_dtype`` as the block is made and keeps only
    those: what the reference computes at every step, made once, so a
    14B-parameter model's bf16 blocks fit beside nothing else of it."""
    kb, ke, kh = split_keys(key, 3)
    blocks = []
    for k in split_keys(kb, n_blocks(cfg)):
        block = _init_block(k, cfg, tp)
        if cast_blocks:
            block = cast_params_for_compute(block, cfg.compute_dtype)
        blocks.append(block)
    params = {
        "embed": dense_init(ke, (cfg.padded_vocab(tp), cfg.d_model),
                            cfg.param_dtype),
        "blocks": blocks,
        "final_ln": filled((cfg.d_model,), 1.0, key),
    }
    if not cfg.tie_embeddings:
        params["lm_head"] = dense_init(
            kh, (cfg.padded_vocab(tp), cfg.d_model), cfg.param_dtype)
    return params


# --------------------------------------------------------------------------
# forward (train / prefill)
# --------------------------------------------------------------------------

def _apply_dense_ffn(p, h, sp: bool = False):
    return swiglu(h, p["wg"], p["wi"], p["wo"], sp)


def _apply_moe(p, h, cfg, moe_mode: str = "dense", sp: bool = False):
    """The MoE FFN in ``moe_mode`` (the reference's dispatch): ``dense``
    without a mesh or on a "model" axis of 1; on a mesh ``a2a`` (this
    rank's share of the tokens through the all-to-all), ``psum``, or
    ``ep2`` for a ``moe_ep_data`` config.  ``sp``: ``h`` is this rank's
    sequence block."""
    b, s, d = h.shape
    mesh = current_mesh()
    data_axis = "data" if (mesh is not None and "data" in mesh.shape
                           and mesh.shape["data"] > 1
                           and current_fsdp()) else None
    if moe_mode == "dense" or mesh is None \
            or mesh.shape.get("model", 1) == 1:
        # on a mesh the experts whole over "data" first (ZeRO-3)
        wg, wi, wo = moe_mod.gather_data(p, data_axis)
        out = moe_mod.moe_ffn_dense(h.reshape(b * s, d),
                                    {**p, "wg": wg, "wi": wi, "wo": wo},
                                    cfg.top_k, cfg.capacity_factor)
        return out.reshape(b, s, d)
    batch = (current_rules() or {}).get("batch")
    if cfg.moe_ep_data and "data" in mesh.shape:
        # the serving layout: experts over (model x data) jointly, always
        # the psum path
        out = moe_mod.moe_ffn_psum_ep2(
            h.reshape(b * s, d), p, cfg.top_k, ("model", "data"),
            batch_axis="data" if batch is not None else None)
        return out.reshape(b, s, d)
    if moe_mode == "a2a":
        return _moe_a2a(p, h, cfg, data_axis, sp)
    out = moe_mod.moe_ffn_psum(h.reshape(b * s, d), p, cfg.top_k, "model",
                               data_axis)
    return out.reshape(b, s, d)


def _moe_a2a(p, h, cfg, data_axis, sp: bool = False):
    """``a2a`` in the reference's layout: this rank's (B, S / mp) block
    of the sequence through the all-to-all.  A whole ``h`` is split
    over "model" first and the outputs all-gathered back (their
    cotangents whole on every rank: each rank takes its block); with
    ``sp`` ``h`` is that block already and stays it.  S must split over
    the "model" axis, as the reference's ``shard_map`` over
    ``P(batch, "model", None)`` requires."""
    if not sp:
        s, mp = h.shape[1], model_size()
        if s % mp:
            raise ValueError(f"a2a shards the sequence over the model axis: "
                             f"{s} tokens do not split over {mp} shards")
        h = col.split(h, "model", dim=1)
    b, sl, d = h.shape
    out = moe_mod.moe_ffn_a2a(h.reshape(b * sl, d), p, cfg.top_k,
                              cfg.capacity_factor, "model", data_axis)
    out = out.reshape(b, sl, d)
    return out if sp else col.all_gather(out, "model", dim=1,
                                         whole_grad=True)


def _apply_ffn(sub, ffn, h, cfg, moe_mode: str = "dense", sp: bool = False):
    hn = norm(h, sub["ln2"], cfg.norm_eps, sp)
    if ffn == "moe":
        return h + _apply_moe(sub["moe"], hn, cfg, moe_mode, sp)
    return h + _apply_dense_ffn(sub["ffn"], hn, sp)


def _check_mesh(cfg: ModelConfig) -> None:
    """A Mamba mixer splits its heads over the "model" axis: they must
    divide evenly."""
    if any(m == "mamba" for m, _ in block_spec(cfg)):
        ssm_mod.shard_heads(cfg, model_size())


def _sublayer_forward(sub, kind, h, pos, pos_host, cfg, nh, nkv,
                      want_cache, max_seq, attn, tap, moe_mode="dense",
                      sp: bool = False):
    mixer, ffn = kind
    cache_out = {}
    hn = norm(h, sub["ln1"], cfg.norm_eps, sp)
    if mixer == "attn":
        out, (k, v) = attn_mod.attention_block(sub["attn"], hn, pos, cfg,
                                               nh, nkv, attn=attn, tap=tap,
                                               sp=sp)
        if want_cache:
            cache_out = attn_mod.prefill_cache(k, v, pos_host, max_seq,
                                               cfg.window)
    else:
        if model_size() > 1:
            out, (st, conv) = ssm_mod.mamba_forward_mesh(sub["mamba"], hn,
                                                         cfg, sp)
        else:
            out, (st, conv) = ssm_mod.mamba_forward(sub["mamba"], hn, cfg)
        if want_cache:
            cache_out = {"ssm": st, "conv": conv}
    h = h + out
    if ffn is not None:
        h = _apply_ffn(sub, ffn, h, cfg, moe_mode, sp)
    return h, cache_out


def _tap(tap, layer: int):
    return None if tap is None else functools.partial(tap, layer)


def _saved_ops():
    """The matmuls the ``dots`` policy keeps: what an ``h @ w`` or an
    expert product dispatches to."""
    aten = torch.ops.aten
    return {aten.mm.default, aten.bmm.default, aten.addmm.default}


def _dots_context():
    """Selective-checkpoint contexts keeping the matmul outputs."""
    from torch.utils.checkpoint import (CheckpointPolicy,
                                        create_selective_checkpoint_contexts)
    keep = _saved_ops()

    def policy(ctx, op, *args, **kwargs):
        return (CheckpointPolicy.MUST_SAVE if op in keep
                else CheckpointPolicy.PREFER_RECOMPUTE)
    return create_selective_checkpoint_contexts(policy)


def remat(body, cfg: ModelConfig, *args, policy: str | None = None):
    """``body(*args)`` under ``torch.utils.checkpoint`` when ``cfg.remat``
    and autograd records a tensor of ``args`` (the reference's
    ``jax.checkpoint`` of a scanned block), with the ``dots`` context
    where ``policy`` (by default ``cfg.remat_policy``) asks for it."""
    if not (cfg.remat and torch.is_grad_enabled() and any(
            isinstance(t, torch.Tensor) and t.requires_grad
            for t in leaves(args))):
        return body(*args)
    if (policy or cfg.remat_policy) == "dots":
        return checkpoint(body, *args, use_reentrant=False,
                          context_fn=_dots_context)
    return checkpoint(body, *args, use_reentrant=False)


def forward(params, tokens, cfg: ModelConfig, tp: int = 1, *,
            prefix_embeds=None, want_cache: bool = False,
            max_seq: int | None = None, attn: str = "kernel", tap=None,
            moe_mode: str = "dense"):
    """Full-sequence forward.  Returns (h_final, caches_or_None).
    ``tap(layer, q, k, v, out, window=, causal=)`` sees every K4 call.
    Without ``want_cache`` each block runs under :func:`remat`, and
    under the rules' ``sp_rs`` ``h_final`` is this rank's sequence block
    (:func:`seq_parallel`)."""
    _check_mesh(cfg)
    nh, nkv = cfg.padded_heads(tp)
    spec = block_spec(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    max_seq = max_seq or s
    sp = seq_parallel(s, want_cache)
    h = embed_tokens(params["embed"], tokens, sp).to(cfg.compute_dtype)
    if prefix_embeds is not None:
        if prefix_embeds.shape[1] > s:
            # the reference's dynamic_update_slice refuses it too
            raise ValueError(f"a prefix of {prefix_embeds.shape[1]} rows "
                             f"does not fit a sequence of {s} tokens")
        h = _with_prefix(h, torch.as_tensor(prefix_embeds, device=dev).to(
            cfg.compute_dtype), sp)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    pos_host = np.arange(s, dtype=np.int32)

    def block(i, hh, block_params):
        block_params = fsdp_gather(cast_params_for_compute(
            block_params, cfg.compute_dtype), ("blocks", i))
        block_caches = {}
        for j, kind in enumerate(spec):
            hh, c = _sublayer_forward(
                block_params[f"sub{j}"], kind, hh, pos, pos_host, cfg, nh,
                nkv, want_cache, max_seq, attn,
                _tap(tap, i * len(spec) + j), moe_mode, sp)
            block_caches[f"sub{j}"] = c
        return hh, block_caches

    caches = []
    for i, block_params in enumerate(params["blocks"]):
        if want_cache:
            h, block_caches = block(i, h, block_params)
            caches.append(block_caches)
        else:
            h = remat(lambda hh, bp, i=i: block(i, hh, bp)[0], cfg, h,
                      block_params)
    h = norm(h, params["final_ln"], cfg.norm_eps, sp)
    return h, caches if want_cache else None


def seq_parallel(s: int, want_cache: bool = False) -> bool:
    """Does a forward over ``s`` tokens keep the residual
    sequence-sharded (the rules' ``sp_rs``, applicable to ``s``)?
    Never while building caches: prefill serves from whole rows."""
    return not want_cache and use_sp_rs(s)


def _with_prefix(h: torch.Tensor, prefix: torch.Tensor,
                 sp: bool) -> torch.Tensor:
    """``h`` with its first positions replaced by ``prefix`` (B, P, d);
    with ``sp`` only those that fall in this rank's block.  A new tensor:
    ``h`` may be a collective's output, which autograd forbids writing
    in place."""
    start = col.axis_index("model") * h.shape[1] if sp else 0
    n = min(prefix.shape[1] - start, h.shape[1])
    if n <= 0:
        return h
    return torch.cat([prefix[:, start:start + n], h[:, n:]], dim=1)


def train_loss(params, batch, cfg: ModelConfig, tp: int = 1, *,
               attn: str = "kernel", tap=None, moe_mode: str = "dense"):
    """batch: {tokens (B, S), labels (B, S), [prefix_embeds]} -> the
    mean next-token NLL, a 0-d f32 tensor (:func:`lm_loss` against the
    tied table or ``lm_head``).  On a mesh ``params`` and the batch's
    rows are this rank's blocks; the loss is the global mean."""
    h, _ = forward(params, batch["tokens"], cfg, tp,
                   prefix_embeds=batch.get("prefix_embeds"), attn=attn,
                   tap=tap, moe_mode=moe_mode)
    table = params.get("lm_head", params["embed"])
    return lm_loss(h, table, batch["labels"], cfg.vocab,
                   sp=seq_parallel(batch["tokens"].shape[1]))


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def local_batch(batch: int) -> int:
    """This rank's rows of a global batch of ``batch`` under the current
    rules' batch axes (``batch`` without a mesh)."""
    mesh, rules = current_mesh(), current_rules() or {}
    n = 1
    for a in (rules.get("batch") or ()) if mesh is not None else ():
        n *= mesh.shape[a]
    return batch // n

def _init_sub_cache(cfg: ModelConfig, mixer: str, batch: int,
                    max_seq: int, nkv: int, device):
    if mixer == "attn":
        return attn_mod.init_cache(batch, max_seq, nkv, cfg.head_dim,
                                   cfg.window,
                                   cfg.kv_cache_dtype or cfg.compute_dtype,
                                   device=device)
    # the SSM state, a recurrent accumulator, in f32; the conv tail in
    # the compute type; on a mesh this rank's heads and its block of
    # the conv channels
    mp = model_size()
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    if conv_dim % mp:
        raise ValueError(f"{conv_dim} conv channels do not split over "
                         f"{mp} model shards")
    return {"ssm": torch.zeros((batch, ssm_mod.shard_heads(cfg, mp),
                                cfg.ssm_head_dim, cfg.ssm_state),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim // mp),
                                dtype=cfg.compute_dtype, device=device)}


def init_cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                    tp: int = 1, *, device="cpu"):
    """Per-block empty decode caches (a list, one dict per block); on a
    mesh this rank's blocks of the caches of a global ``batch``."""
    _check_mesh(cfg)
    _nh, nkv = cfg.padded_heads(tp)
    batch = local_batch(batch)
    return [{f"sub{j}": _init_sub_cache(cfg, mixer, batch, max_seq, nkv,
                                        device)
             for j, (mixer, _) in enumerate(block_spec(cfg))}
            for _ in range(n_blocks(cfg))]


def decode_step(params, caches, token, cur_pos, cfg: ModelConfig,
                tp: int = 1, *, attn: str = "kernel", tap=None,
                moe_mode: str = "dense"):
    """One serve step: token (B, 1) ints, cur_pos a scalar position.
    Writes each block's attention cache in place and replaces its SSM
    caches; returns (logits (B, V), caches).  ``moe_mode`` ``a2a`` runs
    as ``psum``, as in the reference.
    """
    _check_mesh(cfg)
    moe_mode = "psum" if moe_mode == "a2a" else moe_mode
    nh, nkv = cfg.padded_heads(tp)
    spec = block_spec(cfg)
    dev = params["embed"].device
    cur = int(cur_pos)
    h = embed_tokens(params["embed"], torch.as_tensor(token, device=dev)
                     ).to(cfg.compute_dtype)
    for i, (block_params, block_caches) in enumerate(
            zip(params["blocks"], caches)):
        block_params = fsdp_gather(cast_params_for_compute(
            block_params, cfg.compute_dtype), ("blocks", i))
        for j, (mixer, ffn) in enumerate(spec):
            sub = block_params[f"sub{j}"]
            c = block_caches[f"sub{j}"]
            hn = rms_norm(h, sub["ln1"], cfg.norm_eps)
            if mixer == "attn":
                out, block_caches[f"sub{j}"] = attn_mod.decode_block(
                    sub["attn"], hn, c, cur, cfg, nh, nkv, attn=attn,
                    tap=_tap(tap, i * len(spec) + j))
            else:
                decode = ssm_mod.mamba_decode_mesh if model_size() > 1 \
                    else ssm_mod.mamba_decode
                out, (st, conv) = decode(sub["mamba"], hn, cfg, c["ssm"],
                                         c["conv"])
                block_caches[f"sub{j}"] = {"ssm": st, "conv": conv}
            h = h + out
            if ffn is not None:
                h = _apply_ffn(sub, ffn, h, cfg, moe_mode)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    table = params.get("lm_head", params["embed"])
    return lm_logits(h, table, cfg.vocab), caches


def prefill(params, tokens, cfg: ModelConfig, tp: int = 1, *,
            prefix_embeds=None, max_seq: int | None = None,
            attn: str = "kernel", tap=None, moe_mode: str = "dense"):
    """Run the full prompt, return (last-token logits, caches)."""
    h, caches = forward(params, tokens, cfg, tp,
                        prefix_embeds=prefix_embeds, want_cache=True,
                        max_seq=max_seq, attn=attn, tap=tap,
                        moe_mode=moe_mode)
    table = params.get("lm_head", params["embed"])
    return lm_logits(h[:, -1:], table, cfg.vocab), caches
