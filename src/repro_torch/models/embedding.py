"""Token embedding, the training loss and decode-time logits — the
port's copy of ``embed_tokens``, ``lm_loss`` and ``lm_logits`` from
``repro/models/embedding.py``.

On a mesh whose "model" axis is above 1 the table is vocab-sharded:
this rank holds rows ``[r * V_l, (r + 1) * V_l)``.  ``embed_tokens``
gathers the tokens of its range (the others masked to 0) and sums the
partials over "model", or with ``sp`` (the rules' ``sp_rs``)
reduce-scatters that sum onto the sequence, as the reference does.
``lm_logits`` gives this rank's vocab block, the padded vocabulary
masked to -1e30; :func:`gather_logits` joins the blocks (over "model",
then the batch axes) into whole rows.

``lm_loss`` runs the reference's scan over sequence chunks of
:data:`LOSS_CHUNK` as a loop (a sequence that is not a multiple of the
chunk is taken whole, as the reference takes it), each chunk's sums
added in order.  Under autograd each chunk runs inside
``torch.utils.checkpoint``, so one chunk's (B, C, V) f32 logits are
alive at a time in the backward (256000 words a token at
minitron-4b's vocab); that changes memory, not the numbers.  On a mesh
it is the reference's vocab-parallel cross-entropy: ``h`` enters whole
(:func:`~repro_torch.models.layers.column_input`; all-gathered over the
sequence when it arrives sequence-sharded), each rank takes the logits
of its vocab block, the chunk max is a ``pmax`` over "model" outside
autograd, the sum of exponentials and the label's logit are summed over
"model", and the loss sum and the valid count are summed over the
batch axes, so the loss is the global mean on every rank.  (The
reference sums both over every mesh axis; over "model" they are
already whole, and the sum scales both by the same factor.)
"""

from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.models.layers import batch_axes, column_input
from repro_torch.parallel import collectives as col
from repro_torch.parallel.axes import current_mesh, current_rules, model_size

LOSS_CHUNK = 512


def _vocab_start(table: torch.Tensor) -> int:
    """The first vocab id of this rank's rows of ``table``."""
    return col.axis_index("model") * table.shape[0] if model_size() > 1 \
        else 0


def embed_tokens(table: torch.Tensor, tokens: torch.Tensor,
                 sp: bool = False) -> torch.Tensor:
    """tokens (B, S) -> (B, S, d); table (V, d), vocab-sharded over
    "model" on a mesh (a masked gather, then a sum over "model"; with
    ``sp``, reduce-scattered onto the sequence: (B, S / mp, d))."""
    if model_size() == 1:
        return table[tokens]
    v_l = table.shape[0]
    start = _vocab_start(table)
    idx = torch.clamp(tokens - start, 0, v_l - 1)
    mask = (tokens >= start) & (tokens < start + v_l)
    vals = torch.where(mask[..., None], table[idx], 0)
    if sp:
        return col.psum_scatter(vals, "model", dim=1)
    return col.psum(vals, "model")


def _chunk_ce(h_c, table, labels_c, valid_c, real_vocab: int):
    """CE sums of one sequence chunk: h_c (B, C, d), labels_c and
    valid_c (B, C) -> (sum of the valid tokens' NLL, their count).  On a
    vocab-sharded mesh ``table`` is this rank's block and the softmax's
    sums are taken over "model"."""
    logits = h_c.to(torch.float32) @ table.to(torch.float32).T
    v_l = table.shape[0]
    start = _vocab_start(table)
    if start + v_l > real_vocab:   # the padded vocabulary, never a label
        pad = torch.arange(start, start + v_l,
                           device=logits.device) >= real_vocab
        logits = logits.masked_fill(pad, -1e30)
    gmax = logits.detach().amax(dim=-1)
    if model_size() > 1:
        gmax = col.pmax(gmax, "model")
    sumexp = torch.exp(logits - gmax[..., None]).sum(dim=-1)
    if model_size() > 1:
        sumexp = col.psum(sumexp, "model")
    lse = torch.log(sumexp) + gmax
    if model_size() == 1:
        lab = torch.gather(logits, -1, labels_c[..., None])[..., 0]
    else:
        idx = torch.clamp(labels_c - start, 0, v_l - 1)
        mine = (labels_c >= start) & (labels_c < start + v_l)
        lab = torch.gather(logits, -1, idx[..., None])[..., 0]
        lab = col.psum(torch.where(mine, lab, 0.0), "model")
    nll = (lse - lab) * valid_c
    return nll.sum(), valid_c.sum()


def _loss_local(h, table, labels, valid, real_vocab: int,
                chunk: int = LOSS_CHUNK):
    """h: (B, S, d); the chunks' sums added in order."""
    b, s, _ = h.shape
    c = min(chunk, s)
    if s % c:
        c = s
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    remat = torch.is_grad_enabled() and (h.requires_grad
                                         or table.requires_grad)
    for i in range(0, s, c):
        args = (h[:, i:i + c], table, labels[:, i:i + c],
                valid[:, i:i + c], real_vocab)
        ls, cnt = checkpoint(_chunk_ce, *args, use_reentrant=False) \
            if remat else _chunk_ce(*args)
        loss_sum = loss_sum + ls
        count = count + cnt
    return loss_sum, count


def lm_loss(h: torch.Tensor, table: torch.Tensor, labels: torch.Tensor,
            real_vocab: int, sp: bool = False) -> torch.Tensor:
    """Mean next-token NLL.  h: (B, S, d), table: (V, d), labels:
    (B, S) with -1 = ignore; a 0-d f32 tensor.  On a mesh ``h`` and
    ``labels`` are this rank's rows, ``table`` its vocab block, and with
    ``sp`` ``h`` its (B, S / mp, d) sequence block."""
    labels = torch.as_tensor(labels, device=h.device)
    valid = (labels >= 0).to(torch.float32)
    labels_c = torch.clamp(labels, min=0).to(torch.int64)
    h = column_input(h, sp)
    s, c = _loss_local(h, table, labels_c, valid, real_vocab)
    axes = batch_axes()
    if axes:
        s, c = col.psum(s, axes), col.psum(c, axes)
    return s / torch.clamp(c, min=1.0)


def lm_logits(h: torch.Tensor, table: torch.Tensor,
              real_vocab: int) -> torch.Tensor:
    """Logits of the last position in f32: h (B, S, d) -> (B, V), the
    padded vocabulary (ids >= ``real_vocab``) masked to -1e30; on a
    vocab-sharded mesh this rank's block (B, V_l) of them."""
    logits = h[:, -1].to(torch.float32) @ table.to(torch.float32).T
    start = _vocab_start(table)
    pad = real_vocab - start
    if pad < table.shape[0]:
        logits[:, max(pad, 0):] = -1e30
    return logits


def gather_logits(logits: torch.Tensor) -> torch.Tensor:
    """This rank's (B_l, V_l) block of a step's logits -> the whole
    (B, V) rows: all-gathered over "model" (the vocab), then over the
    rules' batch axes (the last first, so the first is major).  Without
    a mesh, ``logits`` itself."""
    if current_mesh() is None:
        return logits
    out = col.all_gather(logits, "model", dim=-1)
    for axis in reversed((current_rules() or {}).get("batch") or ()):
        out = col.all_gather(out, axis, dim=0)
    return out
