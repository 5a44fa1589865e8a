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
otherwise (prefill and training).

The dry-run's stand-ins (the reference's ``input_specs``/``make_batch``):
:meth:`ModelAPI.input_specs` gives an input shape's tensors on the
``meta`` device (shapes and types, the port's ``ShapeDtypeStruct``;
decode's caches from ``init_cache(..., device="meta")``, whose ``pos``
is a host numpy vector); :meth:`ModelAPI.make_batch` draws concrete
ones from a ``torch.Generator`` on its device.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.configs.base import InputShape, ModelConfig
from repro_torch.core.exec_target import resolve_device
from repro_torch.models import encdec, transformer
from repro_torch.models.encdec import ENC_FRAMES
from repro_torch.parallel.axes import current_mesh
from repro_torch.tree import tree_map


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

    # ---- dry-run stand-ins ------------------------------------------------
    def input_specs(self, shape: InputShape) -> dict[str, Any]:
        """The inputs of one step of ``shape`` as ``meta`` tensors (and
        the caches' host ``pos`` vectors)."""
        cfg = self.cfg
        b, s = shape.global_batch, shape.seq_len

        def spec(*dims, dtype=torch.int32):
            return torch.empty(dims, dtype=dtype, device="meta")
        if shape.kind in ("train", "prefill"):
            batch: dict[str, Any] = {"tokens": spec(b, s)}
            if shape.kind == "train":
                batch["labels"] = spec(b, s)
            if cfg.family == "encdec":
                batch["frames"] = spec(b, ENC_FRAMES, cfg.d_model,
                                       dtype=cfg.compute_dtype)
            elif cfg.frontend == "vision_stub":
                batch["prefix_embeds"] = spec(b, cfg.frontend_len,
                                              cfg.d_model,
                                              dtype=cfg.compute_dtype)
            return batch
        # decode: one new token against a seq_len cache
        return {"caches": self.init_cache(b, s, device="meta"),
                "token": spec(b, 1), "cur_pos": spec()}

    def make_batch(self, key: torch.Generator,
                   shape: InputShape) -> dict[str, Any]:
        """Concrete tensors matching :meth:`input_specs`, drawn from
        ``key`` on its device: integer tensors in [0, vocab), 0-d ones
        0, everything else N(0, 1) * 0.02 in its type.  The caches'
        host ``pos`` vectors are integers too, drawn on ``key``'s device
        and brought to the host."""
        dev = key.device

        def concretize(leaf):
            if isinstance(leaf, np.ndarray):
                return torch.randint(0, self.cfg.vocab, leaf.shape,
                                     generator=key, device=dev).cpu(
                                     ).numpy().astype(leaf.dtype)
            if leaf.dim() == 0:
                return torch.zeros((), dtype=leaf.dtype, device=dev)
            if not leaf.dtype.is_floating_point:
                return torch.randint(0, self.cfg.vocab, leaf.shape,
                                     generator=key, device=dev,
                                     dtype=leaf.dtype)
            return (torch.randn(leaf.shape, generator=key, device=dev)
                    * 0.02).to(leaf.dtype)
        return tree_map(concretize, self.input_specs(shape))


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
