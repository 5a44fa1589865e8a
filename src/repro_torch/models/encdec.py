"""Encoder-decoder backbone (whisper-medium) — the port's copy of
``repro/models/encdec.py``.

The conv/mel frontend is a stub, as in the reference: the caller hands
over precomputed frame embeddings (B, T_frames, d).  The encoder is a
non-causal transformer over the frames; the decoder adds a
cross-attention a layer whose K and V are computed once at prefill and
held static in the cache during decode.  Every attention runs on K4
(:mod:`repro_torch.models.attention`): the encoder's non-causal, the
decoder's causal self-attention and its non-causal cross-attention.

``params["enc_blocks"]``/``["dec_blocks"]`` and the decode caches are
lists of per-layer dicts (the reference stacks them on a leading axis
and scans).  A layer's cache is ``{"self": {k, v, pos}, "cross_k",
"cross_v"}``, ``pos`` a host int32 vector.  ``attn`` and ``tap`` pass
through as in :mod:`repro_torch.models.transformer`; ``tap(layer, q, k,
v, out, window=, causal=)`` names its layer ``enc<i>``, ``self<i>`` or
``cross<i>``.

Training (:func:`train_loss`: encode, the decoder, ``lm_loss`` against
the tied table): with ``cfg.remat`` each encoder and decoder layer runs
under ``torch.utils.checkpoint``, as the reference wraps both scanned
bodies in ``jax.checkpoint`` with its default policy (nothing saved,
whatever ``remat_policy`` says).  The encoder's non-causal K4 and the
cross-attention run through the same autograd ``Function`` as the
decoder's self-attention.

On a mesh (as :mod:`repro_torch.models.transformer`): the encoder's
and the decoder's attentions and FFNs are tensor-parallel over
"model"; the decoder's self-attention decodes against a cache whose
slots are sharded over "model"; the cross K/V are kept with every head
on every model rank (the reference's ``_cache_spec`` gives
``cross_k``/``cross_v`` no model axis), each rank reading its own kv
heads.  Training on a mesh: the encoder output enters the cross K/V
projections (column-parallel) once, whole
(:func:`~repro_torch.models.layers.column_input`), for every decoder
layer; under the rules' ``sp_rs`` the encoder's and the decoder's
residuals are each sequence-sharded over "model" where their lengths
split (:func:`~repro_torch.models.transformer.seq_parallel`), the
frames split at the encoder's entry.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention as attn_mod
from repro_torch.models.embedding import embed_tokens, lm_logits, lm_loss
from repro_torch.models.layers import (cast_params_for_compute,
                                       column_input, dense_init, filled,
                                       fsdp_gather, norm, rms_norm,
                                       split_keys)
from repro_torch.models.transformer import (_apply_dense_ffn, _init_ffn,
                                           _tap, local_batch, remat,
                                           seq_parallel)
from repro_torch.parallel import collectives as col

ENC_FRAMES = 1500      # whisper mel frames after the conv frontend


def _init_enc_block(key, cfg, nh, nkv, dtype):
    ks = split_keys(key, 2)
    return {
        "ln1": filled((cfg.d_model,), 1.0, key),
        "attn": attn_mod.init_attention(ks[0], cfg.d_model, nh, nkv,
                                        cfg.head_dim, dtype),
        "ln2": filled((cfg.d_model,), 1.0, key),
        "ffn": _init_ffn(ks[1], cfg, dtype),
    }


def _init_dec_block(key, cfg, nh, nkv, dtype):
    ks = split_keys(key, 3)
    return {
        "ln1": filled((cfg.d_model,), 1.0, key),
        "self_attn": attn_mod.init_attention(ks[0], cfg.d_model, nh, nkv,
                                             cfg.head_dim, dtype),
        "lnx": filled((cfg.d_model,), 1.0, key),
        "cross_attn": attn_mod.init_attention(ks[1], cfg.d_model, nh, nkv,
                                              cfg.head_dim, dtype),
        "ln2": filled((cfg.d_model,), 1.0, key),
        "ffn": _init_ffn(ks[2], cfg, dtype),
    }


def init_params(cfg: ModelConfig, key: torch.Generator | None, tp: int = 1,
                *, cast_blocks: bool = False):
    """Weights drawn from ``key`` on its device (``None``: shapes only,
    on the ``meta`` device).  ``cast_blocks`` keeps each block's matmul
    weights only in ``cfg.compute_dtype``, as
    :func:`~repro_torch.models.transformer.init_params` does."""
    nh, nkv = cfg.padded_heads(tp)
    k1, k2, k3 = split_keys(key, 3)

    def blocks(k, n, init):
        out = []
        for kb in split_keys(k, n):
            block = init(kb, cfg, nh, nkv, cfg.param_dtype)
            if cast_blocks:
                block = cast_params_for_compute(block, cfg.compute_dtype)
            out.append(block)
        return out
    return {
        "embed": dense_init(k3, (cfg.padded_vocab(tp), cfg.d_model),
                            cfg.param_dtype),
        "enc_blocks": blocks(k1, cfg.enc_layers, _init_enc_block),
        "dec_blocks": blocks(k2, cfg.n_layers, _init_dec_block),
        "enc_ln": filled((cfg.d_model,), 1.0, key),
        "final_ln": filled((cfg.d_model,), 1.0, key),
    }


def encode(params, frames, cfg: ModelConfig, tp: int = 1, *,
           attn: str = "kernel", tap=None, sp: bool = False):
    """frames: (B, T, d) stub embeddings -> (B, T, d); with ``sp`` (the
    rules' ``sp_rs``) this rank's (B, T / mp, d) sequence block."""
    nh, nkv = cfg.padded_heads(tp)
    dev = params["embed"].device
    h = torch.as_tensor(frames, device=dev).to(cfg.compute_dtype)
    pos = torch.arange(h.shape[1], dtype=torch.int32, device=dev)
    if sp:
        h = col.split(h, "model", dim=1)

    def block(i, hh, bp):
        bp = fsdp_gather(cast_params_for_compute(bp, cfg.compute_dtype),
                         ("enc_blocks", i))
        out, _ = attn_mod.attention_block(
            bp["attn"], norm(hh, bp["ln1"], cfg.norm_eps, sp), pos, cfg, nh,
            nkv, causal=False, attn=attn, tap=_tap(tap, f"enc{i}"), sp=sp)
        hh = hh + out
        return hh + _apply_dense_ffn(
            bp["ffn"], norm(hh, bp["ln2"], cfg.norm_eps, sp), sp)

    for i, bp in enumerate(params["enc_blocks"]):
        h = remat(lambda hh, p, i=i: block(i, hh, p), cfg, h, bp,
                  policy="nothing")
    return norm(h, params["enc_ln"], cfg.norm_eps, sp)


def _cross_kv(bp, enc_out, cfg, nkv):
    """The cross K and V of this rank's kv heads (``wk``/``wv`` column
    shards on a mesh), with their positions."""
    b, t, _ = enc_out.shape
    nkv_l = bp["cross_attn"]["wk"].shape[1] // cfg.head_dim
    k = (enc_out @ bp["cross_attn"]["wk"]).reshape(b, t, nkv_l,
                                                   cfg.head_dim)
    v = (enc_out @ bp["cross_attn"]["wv"]).reshape(b, t, nkv_l,
                                                   cfg.head_dim)
    return k, v, torch.arange(t, dtype=torch.int32, device=enc_out.device)


def decoder_forward(params, tokens, enc_out, cfg: ModelConfig, tp: int = 1,
                    *, want_cache: bool = False, max_seq: int | None = None,
                    attn: str = "kernel", tap=None, sp_enc: bool = False):
    """The decoder over ``tokens`` (B, S) against ``enc_out`` (with
    ``sp_enc``, this rank's sequence block of it).  Returns (h_final,
    per-layer caches or None); under the rules' ``sp_rs`` and without
    ``want_cache``, ``h_final`` is this rank's sequence block."""
    nh, nkv = cfg.padded_heads(tp)
    dev = params["embed"].device
    tokens = torch.as_tensor(tokens, device=dev)
    b, s = tokens.shape
    max_seq = max_seq or s
    sp = seq_parallel(s, want_cache)
    h = embed_tokens(params["embed"], tokens, sp).to(cfg.compute_dtype)
    pos = torch.arange(s, dtype=torch.int32, device=dev)
    pos_host = np.arange(s, dtype=np.int32)
    enc_out = column_input(enc_out, sp_enc)

    def block(i, hh, bp):
        bp = fsdp_gather(cast_params_for_compute(bp, cfg.compute_dtype),
                         ("dec_blocks", i))
        out, (k, v) = attn_mod.attention_block(
            bp["self_attn"], norm(hh, bp["ln1"], cfg.norm_eps, sp), pos,
            cfg, nh, nkv, attn=attn, tap=_tap(tap, f"self{i}"), sp=sp)
        hh = hh + out
        ck, cv, cpos = _cross_kv(bp, enc_out, cfg, nkv)
        out, _ = attn_mod.attention_block(
            bp["cross_attn"], norm(hh, bp["lnx"], cfg.norm_eps, sp), pos,
            cfg, nh, nkv, cross_kv=(ck, cv, cpos), causal=False, attn=attn,
            tap=_tap(tap, f"cross{i}"), sp=sp)
        hh = hh + out
        hh = hh + _apply_dense_ffn(
            bp["ffn"], norm(hh, bp["ln2"], cfg.norm_eps, sp), sp)
        return hh, (k, v, ck, cv)

    caches = []
    for i, bp in enumerate(params["dec_blocks"]):
        if not want_cache:
            h = remat(lambda hh, p, i=i: block(i, hh, p)[0], cfg, h, bp,
                      policy="nothing")
            continue
        h, (k, v, ck, cv) = block(i, h, bp)
        caches.append({"self": attn_mod.prefill_cache(
            k, v, pos_host, max_seq, cfg.window),
            "cross_k": attn_mod.gather_heads(ck),
            "cross_v": attn_mod.gather_heads(cv)})
    h = norm(h, params["final_ln"], cfg.norm_eps, sp)
    return h, caches if want_cache else None


def train_loss(params, batch, cfg: ModelConfig, tp: int = 1, *,
               attn: str = "kernel", tap=None, moe_mode: str = "dense"):
    """batch: {tokens (B, S), labels (B, S), frames (B, T, d)} -> the
    mean next-token NLL, a 0-d f32 tensor.  On a mesh ``params`` and the
    batch's rows are this rank's blocks; the loss is the global mean.
    ``moe_mode`` is taken for the API's sake (whisper has no MoE)."""
    del moe_mode
    sp_enc = seq_parallel(batch["frames"].shape[1])
    enc_out = encode(params, batch["frames"], cfg, tp, attn=attn, tap=tap,
                     sp=sp_enc)
    h, _ = decoder_forward(params, batch["tokens"], enc_out, cfg, tp,
                           attn=attn, tap=tap, sp_enc=sp_enc)
    return lm_loss(h, params["embed"], batch["labels"], cfg.vocab,
                   sp=seq_parallel(batch["tokens"].shape[1]))


def prefill(params, tokens, frames, cfg: ModelConfig, tp: int = 1, *,
            max_seq: int | None = None, attn: str = "kernel", tap=None):
    """Encode ``frames``, run the prompt; return (last-token logits,
    caches)."""
    enc_out = encode(params, frames, cfg, tp, attn=attn, tap=tap)
    h, caches = decoder_forward(params, tokens, enc_out, cfg, tp,
                                want_cache=True, max_seq=max_seq, attn=attn,
                                tap=tap)
    return lm_logits(h[:, -1:], params["embed"], cfg.vocab), caches


def init_cache_tree(cfg: ModelConfig, batch: int, max_seq: int,
                    tp: int = 1, *, device="cpu"):
    """Per-layer empty decode caches: the self-attention's (``pos`` -1
    on the host) and :data:`ENC_FRAMES` zero cross slots; on a mesh
    this rank's blocks of them for a global ``batch``."""
    _nh, nkv = cfg.padded_heads(tp)
    dtype = cfg.compute_dtype
    batch = local_batch(batch)

    def cross():
        return torch.zeros((batch, ENC_FRAMES, nkv, cfg.head_dim),
                           dtype=dtype, device=device)
    return [{"self": attn_mod.init_cache(batch, max_seq, nkv, cfg.head_dim,
                                         cfg.window, dtype, device=device),
             "cross_k": cross(), "cross_v": cross()}
            for _ in range(cfg.n_layers)]


def decode_step(params, caches, token, cur_pos, cfg: ModelConfig,
                tp: int = 1, *, attn: str = "kernel", tap=None):
    """One serve step: token (B, 1) ints, cur_pos a scalar position.
    Writes each layer's self-attention cache in place; the cross caches
    are read only.  Returns (logits (B, V), caches)."""
    nh, nkv = cfg.padded_heads(tp)
    dev = params["embed"].device
    cur = int(cur_pos)
    h = embed_tokens(params["embed"], torch.as_tensor(token, device=dev)
                     ).to(cfg.compute_dtype)
    for i, (bp, c) in enumerate(zip(params["dec_blocks"], caches)):
        bp = fsdp_gather(cast_params_for_compute(bp, cfg.compute_dtype),
                         ("dec_blocks", i))
        out, c["self"] = attn_mod.decode_block(
            bp["self_attn"], rms_norm(h, bp["ln1"], cfg.norm_eps),
            c["self"], cur, cfg, nh, nkv, attn=attn,
            tap=_tap(tap, f"self{i}"))
        h = h + out
        cpos = np.arange(c["cross_k"].shape[1], dtype=np.int32)
        out, _ = attn_mod.decode_block(
            bp["cross_attn"], rms_norm(h, bp["lnx"], cfg.norm_eps), None,
            cur, cfg, nh, nkv, cross_kv=(c["cross_k"], c["cross_v"], cpos),
            attn=attn, tap=_tap(tap, f"cross{i}"))
        h = h + out
        h = h + _apply_dense_ffn(bp["ffn"],
                                 rms_norm(h, bp["ln2"], cfg.norm_eps))
    h = rms_norm(h, params["final_ln"], cfg.norm_eps)
    return lm_logits(h, params["embed"], cfg.vocab), caches
