"""Decoder stack — the port's copy of ``repro/models/transformer.py`` at
tp = 1, for the dense, MoE, SSM, hybrid and VLM families (the
encoder-decoder family is :mod:`repro_torch.models.encdec`).

``params["blocks"]`` and the decode caches are lists of per-block dicts
(the reference stacks them on a leading axis and scans); a block's
sublayers are ``sub0``, ``sub1``, ... as in the reference
(:func:`block_spec`: one attention or Mamba mixer each, then a dense or
MoE FFN, or none).  Each block's matmul weights are cast to the compute
type as the block runs, as the reference does
(``cast_params_for_compute``); weights made with ``init_params(...,
cast_blocks=True)`` are already of that type, so the cast is a no-op
and the numbers are the same (serving only: training differentiates
the f32 masters).  The MoE FFN runs the reference's ``dense`` mode (no
mesh).

Training (:func:`train_loss`): with ``cfg.remat`` each block, the cast
of its f32 masters included, runs under ``torch.utils.checkpoint``
(non-reentrant), as the reference wraps its scanned block in
``jax.checkpoint``: only the block's input is kept, and the backward
runs the block again (K4 included).  ``remat_policy="dots"`` keeps the
matmul outputs (``aten.mm``/``bmm``: the reference's
``dots_with_no_batch_dims_saveable``) through a selective-checkpoint
context; ``"nothing"`` keeps none.
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
                                       filled, rms_norm, split_keys, swiglu)
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

def _apply_dense_ffn(p, h):
    return swiglu(h, p["wg"], p["wi"], p["wo"])


def _apply_moe(p, h, cfg):
    """The reference's ``dense`` mode: every token of the batch routed
    together."""
    b, s, d = h.shape
    out = moe_mod.moe_ffn_dense(h.reshape(b * s, d), p, cfg.top_k,
                                cfg.capacity_factor)
    return out.reshape(b, s, d)


def _apply_ffn(sub, ffn, h, cfg):
    hn = rms_norm(h, sub["ln2"], cfg.norm_eps)
    if ffn == "moe":
        return h + _apply_moe(sub["moe"], hn, cfg)
    return h + _apply_dense_ffn(sub["ffn"], hn)


def _sublayer_forward(sub, kind, h, pos, pos_host, cfg, nh, nkv,
                      want_cache, max_seq, attn, tap):
    mixer, ffn = kind
    cache_out = {}
    hn = rms_norm(h, sub["ln1"], cfg.norm_eps)
    if mixer == "attn":
        out, (k, v) = attn_mod.attention_block(sub["attn"], hn, pos, cfg,
                                               nh, nkv, attn=attn, tap=tap)
        if want_cache:
            cache_out = attn_mod.cache_from_prefill(k, v, pos_host, max_seq,
                                                    cfg.window)
    else:
        out, (st, conv) = ssm_mod.mamba_forward(sub["mamba"], hn, cfg)
        if want_cache:
            cache_out = {"ssm": st, "conv": conv}
    h = h + out
    if ffn is not None:
        h = _apply_ffn(sub, ffn, h, cfg)
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
            max_seq: int | None = None, attn: str = "kernel", tap=None):
    """Full-sequence forward.  Returns (h_final, caches_or_None).
    ``tap(layer, q, k, v, out, window=, causal=)`` sees every K4 call.
    Without ``want_cache`` each block runs under :func:`remat`."""
    nh, nkv = cfg.padded_heads(tp)
    spec = block_spec(cfg)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    max_seq = max_seq or s
    h = embed_tokens(params["embed"], tokens).to(cfg.compute_dtype)
    if prefix_embeds is not None:
        pl = prefix_embeds.shape[1]
        h[:, :pl] = torch.as_tensor(prefix_embeds, device=dev).to(
            cfg.compute_dtype)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    pos_host = np.arange(s, dtype=np.int32)

    def block(i, hh, block_params):
        block_params = cast_params_for_compute(block_params,
                                               cfg.compute_dtype)
        block_caches = {}
        for j, kind in enumerate(spec):
            hh, c = _sublayer_forward(
                block_params[f"sub{j}"], kind, hh, pos, pos_host, cfg, nh,
                nkv, want_cache, max_seq, attn,
                _tap(tap, i * len(spec) + j))
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
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return h, caches if want_cache else None


def train_loss(params, batch, cfg: ModelConfig, tp: int = 1, *,
               attn: str = "kernel", tap=None):
    """batch: {tokens (B, S), labels (B, S), [prefix_embeds]} -> the
    mean next-token NLL, a 0-d f32 tensor (:func:`lm_loss` against the
    tied table or ``lm_head``)."""
    h, _ = forward(params, batch["tokens"], cfg, tp,
                   prefix_embeds=batch.get("prefix_embeds"), attn=attn,
                   tap=tap)
    table = params.get("lm_head", params["embed"])
    return lm_loss(h, table, batch["labels"], cfg.vocab)


# --------------------------------------------------------------------------
# decode
# --------------------------------------------------------------------------

def _init_sub_cache(cfg: ModelConfig, mixer: str, batch: int,
                    max_seq: int, nkv: int, device):
    if mixer == "attn":
        return attn_mod.init_cache(batch, max_seq, nkv, cfg.head_dim,
                                   cfg.window,
                                   cfg.kv_cache_dtype or cfg.compute_dtype,
                                   device=device)
    # the SSM state, a recurrent accumulator, in f32; the conv tail in
    # the compute type
    conv_dim = cfg.d_inner + 2 * cfg.ssm_state
    return {"ssm": torch.zeros((batch, cfg.ssm_heads, cfg.ssm_head_dim,
                                cfg.ssm_state), dtype=torch.float32,
                               device=device),
            "conv": torch.zeros((batch, cfg.ssm_conv - 1, conv_dim),
                                dtype=cfg.compute_dtype, device=device)}


def init_cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                    tp: int = 1, *, device="cpu"):
    """Per-block empty decode caches (a list, one dict per block)."""
    _nh, nkv = cfg.padded_heads(tp)
    return [{f"sub{j}": _init_sub_cache(cfg, mixer, batch, max_seq, nkv,
                                        device)
             for j, (mixer, _) in enumerate(block_spec(cfg))}
            for _ in range(n_blocks(cfg))]


def decode_step(params, caches, token, cur_pos, cfg: ModelConfig,
                tp: int = 1, *, attn: str = "kernel", tap=None):
    """One serve step: token (B, 1) ints, cur_pos a scalar position.
    Writes each block's attention cache in place and replaces its SSM
    caches; returns (logits (B, V), caches).
    """
    nh, nkv = cfg.padded_heads(tp)
    spec = block_spec(cfg)
    dev = params["embed"].device
    cur = int(cur_pos)
    h = embed_tokens(params["embed"], torch.as_tensor(token, device=dev)
                     ).to(cfg.compute_dtype)
    for i, (block_params, block_caches) in enumerate(
            zip(params["blocks"], caches)):
        block_params = cast_params_for_compute(block_params,
                                               cfg.compute_dtype)
        for j, (mixer, ffn) in enumerate(spec):
            sub = block_params[f"sub{j}"]
            c = block_caches[f"sub{j}"]
            hn = rms_norm(h, sub["ln1"], cfg.norm_eps)
            if mixer == "attn":
                out, block_caches[f"sub{j}"] = attn_mod.decode_block(
                    sub["attn"], hn, c, cur, cfg, nh, nkv, attn=attn,
                    tap=_tap(tap, i * len(spec) + j))
            else:
                out, (st, conv) = ssm_mod.mamba_decode(
                    sub["mamba"], hn, cfg, c["ssm"], c["conv"])
                block_caches[f"sub{j}"] = {"ssm": st, "conv": conv}
            h = h + out
            if ffn is not None:
                h = _apply_ffn(sub, ffn, h, cfg)
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    table = params.get("lm_head", params["embed"])
    return lm_logits(h, table, cfg.vocab), caches


def prefill(params, tokens, cfg: ModelConfig, tp: int = 1, *,
            prefix_embeds=None, max_seq: int | None = None,
            attn: str = "kernel", tap=None):
    """Run the full prompt, return (last-token logits, caches)."""
    h, caches = forward(params, tokens, cfg, tp,
                        prefix_embeds=prefix_embeds, want_cache=True,
                        max_seq=max_seq, attn=attn, tap=tap)
    table = params.get("lm_head", params["embed"])
    return lm_logits(h[:, -1:], table, cfg.vocab), caches
