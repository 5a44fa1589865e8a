"""Unified model API: one entry point per (config, tp) pair — the port's
copy of ``repro/models/api.py`` for every family: the decoder-only stack
(dense, MoE, SSM, hybrid and VLM) and the encoder-decoder
(whisper-medium).

``build(cfg)`` returns a :class:`ModelAPI` whose members close over
:mod:`repro_torch.models.transformer`, or :mod:`repro_torch.models.encdec`
for the ``encdec`` family:

  * ``init(key, cast_blocks=False)``: weights drawn from the
    ``torch.Generator`` ``key``, on its device;
  * ``prefill(params, batch, max_seq=None, **kw)``: ``batch`` holds
    ``tokens`` (B, S) and, for the ``vision_stub`` frontend,
    ``prefix_embeds``, for the encoder-decoder ``frames`` (B, T, d);
    returns (last-token logits, caches);
  * ``decode_step(params, caches, token, cur_pos, **kw)``;
  * ``init_cache(batch, max_seq, device="cuda")``: empty caches on the
    card unless the caller passes ``device="cpu"``;
  * ``train_loss(params, batch, **kw)``: ``batch`` holds ``tokens`` and
    ``labels`` (B, S) and, as for ``prefill``, ``prefix_embeds`` or
    ``frames``; returns the mean next-token NLL (a 0-d f32 tensor),
    differentiable in the f32 master ``params`` (K4's forward, the
    reference's attention VJP as its backward).

``attn`` and ``tap`` pass through every member that runs attention.
``tp`` pads the heads and the vocabulary (and splits the experts into
``tp // E`` slices) as the reference does; on a mesh
(:func:`~repro_torch.parallel.axes.axis_rules` installed) the members
take and return this rank's blocks and ``tp`` must be the mesh's
"model" size.  :func:`_moe_mode` picks the MoE mode as the reference's
does: ``dense`` without a mesh, ``psum`` at decode and ``a2a``
otherwise (prefill and training).  The reference's ``input_specs`` and
``make_batch`` wait for the port's dry-run (ROADMAP.md §1 item 6.3d).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.core.exec_target import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.parallel.axes import current_mesh


def _moe_mode(kind: str) -> str:
    if current_mesh() is None:
        return "dense"
    return "psum" if kind == "decode" else "a2a"


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    tp: int
    init: Callable[..., Any]
    train_loss: Callable[..., Any]
    prefill: Callable[..., Any]
    decode_step: Callable[..., Any]
    init_cache: Callable[..., Any]


def build(cfg: ModelConfig, tp: int = 1) -> ModelAPI:
    if tp < 1:
        raise ValueError(f"tp must be >= 1, got {tp}")
    if cfg.family == "encdec":
        return ModelAPI(
            cfg=cfg, tp=tp,
            init=lambda key, **kw: encdec.init_params(cfg, key, tp, **kw),
            train_loss=lambda p, b, **kw: encdec.train_loss(p, b, cfg, tp,
                                                            **kw),
            prefill=lambda p, b, max_seq=None, **kw: encdec.prefill(
                p, b["tokens"], b["frames"], cfg, tp, max_seq=max_seq,
                **kw),
            decode_step=lambda p, c, tok, pos, **kw: encdec.decode_step(
                p, c, tok, pos, cfg, tp, **kw),
            init_cache=lambda b, s, device="cuda": encdec.init_cache_tree(
                cfg, b, s, tp, device=resolve_device(device)),
        )

    def _prefill(p, b, max_seq=None, **kw):
        return transformer.prefill(p, b["tokens"], cfg, tp,
                                   prefix_embeds=b.get("prefix_embeds"),
                                   max_seq=max_seq,
                                   moe_mode=_moe_mode("prefill"), **kw)

    def _decode(p, c, tok, pos, **kw):
        return transformer.decode_step(p, c, tok, pos, cfg, tp,
                                       moe_mode=_moe_mode("decode"), **kw)

    def _init_cache(b, s, device="cuda"):
        return transformer.init_cache_tree(cfg, b, s, tp,
                                           device=resolve_device(device))

    def _train_loss(p, b, **kw):
        return transformer.train_loss(p, b, cfg, tp,
                                      moe_mode=_moe_mode("train"), **kw)

    return ModelAPI(
        cfg=cfg, tp=tp,
        init=lambda key, **kw: transformer.init_params(cfg, key, tp, **kw),
        train_loss=_train_loss,
        prefill=_prefill,
        decode_step=_decode,
        init_cache=_init_cache,
    )
