"""Losses (port of ``repro.models.losses``).  The vocab cross-entropy is
chunked over the sequence so that the (B, S, V) logits are never held
whole: each chunk's head GEMM (``mp_dot``, K1) and softmax run under
``torch.utils.checkpoint``, so the backward recomputes the chunk's logits,
as the reference's checkpointed scan does (without an RNG state: nothing
here draws random numbers; ``LM._layer`` says why that matters)."""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.gemm import mp_dot


def _chunk_nll(h, head, labels, mask, tied, policy, valid_vocab):
    """Summed masked NLL of one chunk: (B, C, d) hidden -> f32 0-d."""
    logits = mp_dot(h, head, policy=policy, trans_w=tied).float()
    vp = logits.shape[-1]
    if valid_vocab is not None and valid_vocab < vp:
        pad = torch.arange(vp, device=logits.device) >= valid_vocab
        logits = logits.masked_fill(pad, -1e30)
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[..., None].long())[..., 0]
    return ((lse - gold) * mask).sum()


def chunked_softmax_xent(hidden, head, labels, *, tied: bool = False,
                         policy="bf16", chunk: int = 512, mask=None,
                         valid_vocab=None):
    """Mean next-token cross-entropy of ``hidden`` (B, S, d) against
    ``labels`` (B, S) through ``head`` ((d, V), or the tied (V, d)
    embedding read as B^T); ``mask`` (B, S) marks valid tokens, columns at
    or past ``valid_vocab`` (the padded vocab) are masked out."""
    b, s, _ = hidden.shape
    chunk = min(chunk, s)
    pad = (-s) % chunk
    if mask is None:
        mask = torch.ones(b, s, dtype=torch.float32, device=hidden.device)
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        labels = F.pad(labels, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c0 in range(0, hidden.shape[1], chunk):
        sl = slice(c0, c0 + chunk)
        total = total + checkpoint(
            _chunk_nll, hidden[:, sl], head, labels[:, sl], mask[:, sl],
            tied, policy, valid_vocab, use_reentrant=False,
            preserve_rng_state=False)
    return total / mask.sum().clamp_min(1.0)
