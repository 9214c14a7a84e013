"""Model assembly (port of ``repro.models.transformer``): :class:`LM` with
``init``, training of every block kind (``init_train`` / ``train_params``
for the f32 master parameters, ``loss_fn`` with per-layer
rematerialisation), the wave path
(``prefill`` over left-padded prompts and ``decode_step`` against
per-layer ring caches, with whisper's encoder stack) and the paged path
(``init_paged_caches``, ``paged_step``; dense and MoE kinds only), and
:func:`params_from_jax`, which carries a reference parameter tree across
so both packages compute the same function.

Parameters are a plain dict: ``embed`` (Vp, d), ``final_norm``, ``head``
(d, Vp) when untied, ``pos_embed`` (32776, d) for learned positions, and
``layers``, a list of per-layer block dicts in layer order (the reference
stacks them per unit kind for ``lax.scan``).  An audio (enc-dec) model adds
``encoder`` (a list of dense layers; the reference's is one stack with a
leading layer axis), ``enc_norm`` and ``enc_pos`` (encoder_seq, d).  A
dense layer keeps its projections in the ``attn`` and ``mlp`` sub-dicts
(a GELU MLP also its f32 biases ``b_up``, ``b_down``); an enc-dec layer
adds ``lnx`` and the cross-attention ``xattn``; a VLM's cross layer keeps
``xattn``, ``mlp`` and the f32 scalar gates ``gate_attn``, ``gate_mlp``;
an MoE layer keeps ``attn`` and, at its top level, the f32 ``router`` (d,
E) and the (E, ., .) expert stacks ``w_gate``, ``w_up``, ``w_down``; the
recurrent layers keep the leaves of ``models/recurrent.py``.  A GEMM
weight is a dense tensor or, once packed (``LM.init(pack=True)`` or
``packing.params.pack_params``), a
:class:`~repro_torch.packing.layout.PackedOperand`, or once sparsified
(``LM.init(sparsity=...)`` or ``sparse.params.sparsify_params``), a
:class:`~repro_torch.sparse.layout.TileSparseOperand` (either grouped for
an expert stack), or, stored in static int8
(``core.quantization.quantize_params``), the reference's ``{"q": int8,
"scale": f32 0-d}`` dict, which ``mp_dot`` dequantizes per call.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, segment_pattern
from repro_torch.core.codecs import dtype_name
from repro_torch.core.policy import get_policy
from repro_torch.core.quantization import is_quantized
from repro_torch.models import blocks as B
from repro_torch.models import recurrent as R
from repro_torch.models.layers import (
    embed_init, logits_from_hidden, rope_frequencies,
)
from repro_torch.models.losses import chunked_softmax_xent
from repro_torch.packing.layout import PackedLayout, PackedOperand
from repro_torch.packing.params import pack_params
from repro_torch.sparse.layout import TileSparseLayout, TileSparseOperand
from repro_torch.sparse.params import nm_for_sparsity, sparsify_params

# Block kinds the port's paged-KV serving path runs; the wave path runs
# every kind: also whisper's enc-dec decoder block, a VLM's cross block and
# the recurrent kinds (their caches are not paged, as in the reference).
# Every kind serves under every policy, packed and tile-sparse, and trains
# (``init_train``, ``loss_fn``).
PAGED_KINDS = ("dense", "attn_local", "moe")
WAVE_KINDS = PAGED_KINDS + ("encdec", "cross", "rwkv", "rglru")

# Rows of the learned decoder position table (the reference's 32768 + 8).
POS_EMBED_ROWS = 32768 + 8

# Serve-time MoE capacity factor, as in the reference's paged step: at 4.0
# an expert holds every token of a sequence whenever top-k picks each
# expert at most once per token (granite: cap = s).
MOE_SERVE_CAPACITY = 4.0
# Training's MoE capacity factor: the reference's ``moe_mlp`` default.
MOE_TRAIN_CAPACITY = 1.25


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, refusing a CUDA device when no card is
    present: the port never quietly runs a CUDA request on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' (--device cpu) "
            "to run the port's plain PyTorch path on the CPU")
    return dev


def _window(cfg, kind):
    return cfg.local_attn_window if kind == "attn_local" else cfg.window


_INIT = {"dense": B.init_dense, "attn_local": B.init_dense,
         "moe": B.init_moe, "cross": B.init_cross, "encdec": B.init_encdec,
         "rwkv": R.init_rwkv, "rglru": R.init_rglru}
# The wave path's blocks by kind: over a prompt, at a decode step, and
# their caches' init (the windowed attention kinds are the default).
_FWD = {"cross": B.cross_fwd, "encdec": B.encdec_fwd, "rwkv": R.rwkv_fwd,
        "rglru": R.rglru_fwd}
_DECODE = {"moe": B.moe_decode, "cross": B.cross_decode,
           "encdec": B.encdec_decode, "rwkv": R.rwkv_decode,
           "rglru": R.rglru_decode}
_INIT_CACHE = {"cross": B.cross_init_cache, "encdec": B.encdec_init_cache,
               "rwkv": R.rwkv_init_cache, "rglru": R.rglru_init_cache}


def _block_fwd(kind, layer, x, ctx):
    """-> (x, aux, cache | None) of one block over a whole prompt."""
    if kind == "moe":
        return B.moe_fwd(layer, x, ctx, window=ctx["cfg"].window)
    if kind in _FWD:
        return _FWD[kind](layer, x, ctx)
    return B.dense_fwd(layer, x, ctx, window=_window(ctx["cfg"], kind))


def _block_decode(kind, layer, x, cache, ctx):
    """-> x of one block at one token; ``cache`` is updated in place."""
    return _DECODE.get(kind, B.dense_decode)(layer, x, cache, ctx)


def _block_init_cache(kind, cfg, batch, max_len, dtype, device):
    if kind in _INIT_CACHE:
        return _INIT_CACHE[kind](cfg, batch, max_len, dtype, device=device)
    return B.attn_init_cache(cfg, batch, max_len, dtype,
                             window=_window(cfg, kind), device=device)


# The GEMM weights of a layer, wherever they sit in its dict: cast once to
# the compute dtype at load time (mp_dot would cast them on every call; a
# cast done once gives the same bits).  Under the int8 policy they stay
# f32, as in the reference, and mp_dot quantizes them per call.  Packed
# weights, norm scales and the MoE router (an f32 GEMM under every policy)
# are left as they are.
# The recurrent kinds' f32-policy weights (``lora_b``, ``w_gate_r``,
# ``w_gate_i``) and the plain f32 ``w_lora_b`` stay f32.
_GEMM_WEIGHTS = frozenset({"wq", "wk", "wv", "wo", "w_gate", "w_up",
                           "w_down", "wr", "wg", "lora_a", "w_lora_a", "ck",
                           "cv", "cr", "w_x", "w_y", "w_out"})


@dataclasses.dataclass
class LM:
    """Decoder LM (with whisper's encoder for an audio config); ``device``
    defaults to the card.  ``remat`` recomputes each layer's activations in
    the backward (``torch.utils.checkpoint``), as the reference's
    ``jax.checkpoint`` of its scan body.  ``fused_epilogues=False`` runs
    every MLP unfused (the reference's ``fused_epilogue(False)``): the
    same GEMMs, the gating and the residual as separate ops."""

    cfg: ArchConfig
    policy: str = "bf16"
    device: Any = "cuda"
    remat: bool = True
    fused_epilogues: bool = True

    def __post_init__(self):
        bad = sorted({k for k in self.cfg.pattern if k not in WAVE_KINDS})
        if bad:
            raise ValueError(f"unknown block kinds {bad} (the kinds: "
                             f"{WAVE_KINDS})")
        if self.cfg.pos_embed not in ("rope", "learned", "none"):
            raise ValueError(
                f"unknown position embedding {self.cfg.pos_embed!r}")
        self.device = resolve_device(self.device)
        pol = get_policy(self.policy)
        self.compute_dtype = pol.compute
        self.act_dtype = pol.out
        # The dtype dense GEMM weights are stored in: the compute dtype, or
        # f32 under the int8 policy (quantized per call).
        self.weight_dtype = torch.float32 if pol.quantized else pol.compute

    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up to 128; the padded logits are masked."""
        return ((self.cfg.vocab + 127) // 128) * 128

    # ------------------------------ init ------------------------------------

    def init(self, generator: torch.Generator, *, pack: bool = False,
             pack_format: Optional[str] = None, sparsity: float = 0.0,
             sparsity_method: str = "magnitude",
             sparsity_blocks: Optional[Tuple[int, int]] = None
             ) -> Dict[str, Any]:
        """Random parameters drawn on the model's device from ``generator``
        (which must live on that device), with the reference's
        distributions, then cast for the policy (:meth:`load_params`).

        ``pack=True`` packs every GEMM weight (``packing.params``) from its
        f32 draw, before any cast, with the payload ``pack_format`` (None:
        the policy's) in the port's 128 x 128 blocks.

        ``sparsity`` > 0 prunes that fraction of every GEMM weight's tiles
        instead (``sparse.params.sparsify_params``: ``sparsity_method``
        ``"magnitude"`` keeps the top ``1 - sparsity`` of the tiles, ``"nm"``
        keeps ``nm_for_sparsity(sparsity)`` of every 4 k-tiles), on
        ``sparsity_blocks`` (default 128 x 128).  The layers that the
        reference stacks share one pattern, whose scores need every layer
        of the stack, so the whole f32 draw is made first (phi3-mini's is
        15.3 GB), then sparsified, then freed.
        """
        if pack and sparsity > 0:
            raise ValueError("pack and sparsity are mutually exclusive (a "
                             "weight is stored packed-dense or tile-sparse)")
        if not 0.0 <= sparsity < 1.0:
            raise ValueError(f"sparsity must be in [0, 1), got {sparsity}")
        def prepare(tree, path):
            # Pack or cast each part as it is drawn: the f32 draft of a
            # full-width model would not have to fit beside the result.
            # ``path`` (("layers", 3), ...) names its weights in the pack
            # cache.
            if sparsity > 0:
                return tree
            if pack:
                return pack_params(tree, policy=self.policy,
                                   pack_format=pack_format, prefix=path)
            return self._cast_layer(tree)

        def prepare_head(head):
            if not pack:
                return head
            return pack_params({"head": head}, policy=self.policy,
                               pack_format=pack_format)["head"]

        params = self._draw(generator, prepare, prepare_head)
        if sparsity > 0:
            params = sparsify_params(
                params, cfg=self.cfg, density=1.0 - sparsity,
                method=sparsity_method, nm=nm_for_sparsity(sparsity),
                policy=self.policy, blocks=sparsity_blocks)
        return self.load_params(params)

    def init_train(self, generator: torch.Generator) -> Dict[str, Any]:
        """Random f32 master parameters on the model's device, with the
        distributions of :meth:`init` and no cast: training keeps f32
        weights and ``mp_dot`` casts them per call, as the reference
        does."""
        return self._draw(generator, lambda tree, path: tree,
                          lambda head: head)

    def _draw(self, generator, prepare, prepare_head) -> Dict[str, Any]:
        """The f32 draw of every parameter on the model's device, each
        layer passed through ``prepare(layer, ("layers" | "encoder",
        index))`` and the head through ``prepare_head`` as they are
        drawn."""
        cfg, dev = self.cfg, self.device
        kw = dict(generator=generator, device=dev)
        params: Dict[str, Any] = {
            "embed": embed_init(self.vocab_padded, cfg.d_model, **kw),
            "final_norm": B.init_norm(cfg, device=dev),
        }
        if not cfg.tie_embeddings:
            params["head"] = prepare_head(
                torch.randn(cfg.d_model, self.vocab_padded, **kw) * 0.02)
        if cfg.pos_embed == "learned":
            params["pos_embed"] = embed_init(POS_EMBED_ROWS, cfg.d_model, **kw)
        params["layers"] = [prepare(_INIT[kind](cfg, **kw), ("layers", i))
                            for i, kind in enumerate(cfg.pattern)]
        if cfg.encoder_layers:
            params["encoder"] = [prepare(B.init_dense(cfg, **kw),
                                         ("encoder", i))
                                 for i in range(cfg.encoder_layers)]
            params["enc_norm"] = B.init_norm(cfg, device=dev)
            params["enc_pos"] = embed_init(cfg.encoder_seq, cfg.d_model, **kw)
        return params

    def _cast_layer(self, layer):
        def cast(node, name=None):
            if isinstance(node, dict):
                return {k: cast(v, k) for k, v in node.items()}
            if name in _GEMM_WEIGHTS and isinstance(node, torch.Tensor):
                return node.to(self.weight_dtype)
            return node
        return cast(layer)

    def load_params(self, params) -> Dict[str, Any]:
        """Move ``params`` to the model's device and cast the dense GEMM
        weights and head to :attr:`weight_dtype` and the embedding and
        position tables to the activation dtype (both what the reference
        casts them to per use).  Packed and sparse weights and static int8
        ``{"q", "scale"}`` dicts move as they are."""
        dev = self.device

        def to(t, dtype=None):
            if isinstance(t, dict):
                return {k: to(v) for k, v in t.items()}
            if isinstance(t, (PackedOperand, TileSparseOperand)):
                return t.to(dev)
            return t.to(device=dev, dtype=dtype or t.dtype)

        out = {
            "embed": to(params["embed"], self.act_dtype),
            "final_norm": to(params["final_norm"]),
            "layers": [to(self._cast_layer(layer))
                       for layer in params["layers"]],
        }
        if "head" in params:
            out["head"] = to(params["head"], self.weight_dtype)
        if "pos_embed" in params:
            out["pos_embed"] = to(params["pos_embed"], self.act_dtype)
        if "encoder" in params:
            out["encoder"] = [to(self._cast_layer(layer))
                              for layer in params["encoder"]]
            out["enc_norm"] = to(params["enc_norm"])
            out["enc_pos"] = to(params["enc_pos"], self.act_dtype)
        return out

    def train_params(self, params) -> Dict[str, Any]:
        """``params`` (dense tensors, e.g. from :func:`params_from_jax`)
        as f32 master parameters on the model's device: every leaf f32,
        nothing cast to the policy's dtypes.  Packed, sparse and static
        int8 weights are refused (``TypeError``): the reference trains none
        of them either."""
        def to(node):
            if is_quantized(node):
                raise TypeError("training takes dense tensors, got a static "
                                "int8 {'q', 'scale'} weight")
            if isinstance(node, dict):
                return {k: to(v) for k, v in node.items()}
            if isinstance(node, list):
                return [to(v) for v in node]
            if not isinstance(node, torch.Tensor):
                raise TypeError(f"training takes dense tensors, got "
                                f"{type(node).__name__}")
            return node.to(device=self.device, dtype=torch.float32)
        return to(params)

    # ------------------------------ helpers ---------------------------------

    def _head_logits(self, params, x):
        """Final norm, head and the padded-vocab mask of hidden (B, 1, d)."""
        cfg = self.cfg
        x = B.norm(params["final_norm"], x, cfg)
        tied = cfg.tie_embeddings
        head = params["embed"] if tied else params["head"]
        return self._mask_logits(
            logits_from_hidden(x, head, tied=tied, policy=self.policy))

    def _ctx(self, **extra):
        cfg = self.cfg
        ctx = {"cfg": cfg, "policy": self.policy,
               "fused": self.fused_epilogues, "rope": None,
               "positions": None, "causal": cfg.causal,
               "collect_cache": False, "cache_dtype": self.act_dtype,
               "moe_capacity": MOE_SERVE_CAPACITY}
        ctx.update(extra)
        return ctx

    def _embed(self, params, tokens):
        """The token rows, plus the learned positions' (a slice).  The
        gather is ``F.embedding``: its backward sums each id's rows in a
        fixed order on the card, where indexing's (``index_put_`` with
        accumulate) promises none."""
        x = torch.nn.functional.embedding(tokens.long(), params["embed"]).to(
            self.act_dtype)
        if self.cfg.pos_embed == "learned":
            x = x + params["pos_embed"][:tokens.shape[1]][None].to(
                self.act_dtype)
        return x

    def _layer(self, fn, *args):
        """``fn(*args)``, rematerialised in the backward when ``remat``
        holds and autograd records the call.  The checkpoint keeps no RNG
        state (``preserve_rng_state=False``): a training step draws no
        random numbers (only the init does), so the recompute is exact
        without it; and saving the card's generator state in the forward
        and setting it again in the backward is host work that a captured
        step (``train.train_step.TrainStepGraph``) would not repeat on a
        replay."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(fn, *args, use_reentrant=False,
                              preserve_rng_state=False)
        return fn(*args)

    def _encode(self, params, audio_embeds):
        """Whisper's encoder: a non-causal dense stack over the (stubbed)
        frame embeddings plus ``enc_pos``, then ``enc_norm``."""
        x = audio_embeds.to(self.act_dtype)
        x = x + params["enc_pos"][:x.shape[1]][None].to(self.act_dtype)
        ctx = self._ctx(causal=False)
        for layer in params["encoder"]:
            x, _, _ = self._layer(B.dense_fwd, layer, x, ctx)
        return B.norm(params["enc_norm"], x, self.cfg)

    def _cross_states(self, params, batch):
        if self.cfg.family == "vlm":
            return batch["image_embeds"].to(self.act_dtype)
        if self.cfg.family == "audio":
            return self._encode(params, batch["audio_embeds"])
        return None

    def _run_stack(self, params, x, ctx):
        """-> (x, summed aux, per-layer caches | None)."""
        aux, caches = 0.0, []
        for kind, layer in zip(self.cfg.pattern, params["layers"]):
            x, a, cache = _block_fwd(kind, layer, x, ctx)
            aux = aux + a
            caches.append(cache)
        return x, aux, (caches if ctx["collect_cache"] else None)

    # ------------------------------ training --------------------------------

    def loss_fn(self, params, batch) -> torch.Tensor:
        """Mean next-token cross-entropy plus the MoE auxiliary loss of
        ``batch["tokens"]`` (B, S + 1) (and ``audio_embeds`` for an audio
        model, ``image_embeds`` (B, n_image_tokens, d) for a VLM): an f32
        0-d tensor that autograd differentiates.  Each layer is
        rematerialised under ``remat`` (a recurrence's scan also each
        chunk, ``models.recurrent._chunk_scan``); MoE layers route at the
        training capacity (1.25)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        x = self._embed(params, tokens[:, :-1])
        labels = tokens[:, 1:]
        s = x.shape[1]
        ctx = self._ctx(moe_capacity=MOE_TRAIN_CAPACITY)
        if cfg.pos_embed == "rope":
            ctx["rope"] = rope_frequencies(cfg.head_dim, s, cfg.rope_theta,
                                           device=self.device)
            ctx["positions"] = torch.arange(s, device=self.device)[None]
        ctx["cross_states"] = self._cross_states(params, batch)
        aux = 0.0
        for kind, layer in zip(cfg.pattern, params["layers"]):
            x, a, _ = self._layer(_block_fwd, kind, layer, x, ctx)
            aux = aux + a
        x = B.norm(params["final_norm"], x, cfg)
        tied = cfg.tie_embeddings
        head = params["embed"] if tied else params["head"]
        loss = chunked_softmax_xent(x, head, labels, tied=tied,
                                    policy=self.policy, valid_vocab=cfg.vocab)
        return loss + aux

    # ------------------------- wave serving ---------------------------------

    @torch.inference_mode()
    def init_caches(self, batch_size: int,
                    max_len: int) -> List[Dict[str, Any]]:
        """Zeroed per-layer caches of the wave path (ring caches of
        ``min(window, max_len)`` slots; enc-dec layers add the cross K/V)."""
        return [_block_init_cache(kind, self.cfg, batch_size, max_len,
                                  self.act_dtype, self.device)
                for kind in self.cfg.pattern]

    @torch.inference_mode()
    def prefill(self, params, batch, max_len: Optional[int] = None):
        """Run whole (left-padded) prompts: ``batch["tokens"]`` (B, S) and,
        for audio, ``batch["audio_embeds"]`` (B, encoder_seq, d), for a VLM
        ``batch["image_embeds"]`` (B, n_image_tokens, d).  Every row sits
        at positions 0..S-1, pads included (their tokens enter a recurrent
        state too), as in the reference.
        -> (last-token logits (B, Vp), per-layer caches of ``max_len``
        slots)."""
        cfg = self.cfg
        tokens = batch["tokens"]
        s = tokens.shape[1]
        max_len = max_len or s
        x = self._embed(params, tokens)
        ctx = self._ctx(collect_cache=True, cache_len=max_len)
        if cfg.pos_embed == "rope":
            ctx["rope"] = rope_frequencies(cfg.head_dim, s, cfg.rope_theta,
                                           device=self.device)
            ctx["positions"] = torch.arange(s, device=self.device)[None]
        ctx["cross_states"] = self._cross_states(params, batch)
        x, _, caches = self._run_stack(params, x, ctx)
        return self._head_logits(params, x[:, -1:])[:, 0], caches

    def _decode_rope(self, pos):
        """Single-row (cos, sin) tables at ``pos`` (a 0-d device tensor),
        (1, hd / 2) f32: the angle is the reference's f32 product."""
        hd, theta = self.cfg.head_dim, self.cfg.rope_theta
        inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=torch.float32,
                                            device=self.device) / hd))
        ang = inv * pos.float()
        return torch.cos(ang)[None], torch.sin(ang)[None]

    @torch.inference_mode()
    def decode_step(self, params, token, caches, pos):
        """token: (B, 1) int; ``pos``: the count of tokens every row has
        seen, shared by the wave: a 0-d integer tensor on the model's
        device (an int is moved there).  Nothing here reads ``pos`` on the
        host, so a captured step (``serve.engine.WaveGraph``) replays at
        whatever position its buffer holds.  The caches are updated in
        place.  -> (logits (B, Vp), caches)."""
        cfg = self.cfg
        b = token.shape[0]
        pos = torch.as_tensor(pos, device=self.device).long()
        x = params["embed"][token.long()].to(self.act_dtype)
        if cfg.pos_embed == "learned":
            pe = params["pos_embed"]
            row = pe.index_select(0, pos.clamp(max=pe.shape[0] - 1).reshape(1))
            x = x + row[None]
        ctx = self._ctx(pos=pos)
        if cfg.pos_embed == "rope":
            ctx["rope"] = self._decode_rope(pos)
            ctx["positions"] = torch.zeros(b, 1, dtype=torch.long,
                                           device=self.device)
        for kind, layer, cache in zip(cfg.pattern, params["layers"], caches):
            x = _block_decode(kind, layer, x, cache, ctx)
        return self._head_logits(params, x)[:, 0], caches

    # ------------------------- paged serving --------------------------------

    def paged_unsupported_reason(self) -> Optional[str]:
        """None if every block kind has a paged-KV step, else why not."""
        bad = sorted({k for k in self.cfg.pattern if k not in PAGED_KINDS})
        if bad:
            return (f"block kinds {bad} have no paged-KV step (supported: "
                    f"{PAGED_KINDS}); serve this arch with the wave engine")
        return None

    @torch.inference_mode()
    def init_paged_caches(self, num_pages: int,
                          page_size: int) -> List[Dict[str, torch.Tensor]]:
        """One (num_pages, Hkv, page_size, hd) K/V pool pair per layer, in
        the activation dtype; the block tables are shared across layers."""
        reason = self.paged_unsupported_reason()
        if reason:
            raise ValueError(reason)
        return [B.attn_paged_init_cache(self.cfg, num_pages, page_size,
                                        self.act_dtype, device=self.device)
                for _ in self.cfg.pattern]

    def _mask_logits(self, logits):
        vp = self.vocab_padded
        if vp == self.cfg.vocab:
            return logits
        # masked_fill takes the fill as a scalar: a fill tensor built from a
        # Python number would be copied from pageable host memory, and that
        # copy waits for the stream, once per step.
        valid = torch.arange(vp, device=logits.device) < self.cfg.vocab
        return logits.masked_fill(~valid, -1e30)

    @torch.inference_mode()
    def paged_step(self, params, tokens, caches, block_tables, q_start,
                   n_valid):
        """One continuous-batching step over paged KV.

        tokens: (B, C) int — C == 1 is a pure decode step, C > 1 a
        chunked-prefill step (decode rows use one valid column);
        block_tables: (B, W) int32 physical page ids (0 = scratch);
        q_start: (B,) position of each row's first token; n_valid: (B,)
        valid tokens per row (0 = idle slot).  All on the model's device.
        -> (logits (B, Vp) at each row's LAST valid token, caches); the
        caches' pages are updated in place.
        """
        cfg = self.cfg
        b, c = tokens.shape
        dev = self.device
        ps = caches[0]["k_pages"].shape[-2]
        w = block_tables.shape[1]
        max_pos = w * ps
        q_start = q_start.to(torch.int32)
        n_valid = n_valid.to(torch.int32)
        positions = (q_start.long()[:, None]
                     + torch.arange(c, device=dev)[None, :]
                     ).clamp(0, max_pos - 1)
        x = params["embed"][tokens.long()].to(self.act_dtype)
        ctx = {
            "cfg": cfg, "policy": self.policy,
            "fused": self.fused_epilogues,
            "rope": rope_frequencies(cfg.head_dim, max_pos, cfg.rope_theta,
                                     device=dev),
            "positions": positions,
            "paged": {
                "block_tables": block_tables.to(torch.int32).contiguous(),
                "q_start": q_start.contiguous(),
                "n_valid": n_valid.contiguous(),
                "lengths": (q_start + n_valid).contiguous(),
            },
        }
        for kind, layer, cache in zip(cfg.pattern, params["layers"], caches):
            if kind == "moe":
                x = B.moe_paged_step(layer, x, cache, ctx,
                                     window=_window(cfg, kind),
                                     capacity_factor=MOE_SERVE_CAPACITY)
            else:
                x = B.dense_paged_step(layer, x, cache, ctx,
                                       window=_window(cfg, kind))
        # Each row's next-token logits live at its LAST valid position
        # (idle rows clamp to column 0 — the engine ignores them).
        idx = (n_valid.long() - 1).clamp(0, c - 1)
        x = x[torch.arange(b, device=dev), idx][:, None]          # (B, 1, d)
        return self._head_logits(params, x)[:, 0], caches


def build_model(cfg: ArchConfig, policy: str = "bf16", device="cuda",
                remat: bool = True, fused_epilogues: bool = True) -> LM:
    # Audio (enc-dec) archs run the 'encdec' block kind in the decoder.
    if cfg.family == "audio" and not cfg.block_pattern:
        cfg = dataclasses.replace(cfg,
                                  block_pattern=("encdec",) * cfg.n_layers)
    return LM(cfg, policy=policy, device=device, remat=remat,
              fused_epilogues=fused_epilogues)


def _packed_from_jax(p, idx=None) -> PackedOperand:
    """A reference ``PackedOperand`` with numpy leaves (a stacked one is
    sliced at layer ``idx``; a grouped one keeps its group axis) as the
    port's, on the CPU.  ``torch.from_numpy`` refuses ml_dtypes' bfloat16
    and float8_e4m3fn, so their bytes cross as uint16 / uint8 and are
    viewed back."""
    lay = p.layout
    layout = PackedLayout(k=lay.k, n=lay.n, bk=lay.bk, bn=lay.bn,
                          dtype=lay.dtype, orig_dtype=lay.orig_dtype,
                          trans_w=lay.trans_w, g=lay.g)
    payload = np.asarray(p.payload if idx is None else p.payload[idx])
    want = layout.storage_dtype
    if want in (torch.bfloat16, torch.float8_e4m3fn):
        raw = np.uint16 if want == torch.bfloat16 else np.uint8
        tensor = torch.from_numpy(payload.view(raw).copy()).view(want)
    else:
        tensor = torch.from_numpy(payload.copy())
    if tensor.dtype != want or tuple(tensor.shape) != layout.payload_shape:
        raise ValueError(f"packed leaf {layout.describe()}: payload "
                         f"{tensor.dtype} {tuple(tensor.shape)}")
    scales = None
    if p.scales is not None:
        scales = torch.from_numpy(np.asarray(
            p.scales if idx is None else p.scales[idx],
            dtype=np.float32).copy())
    return PackedOperand(tensor, scales, layout)


def _sparse_from_jax(p, idx=None) -> TileSparseOperand:
    """A reference ``TileSparseOperand`` with numpy leaves (a stacked one
    is sliced at layer ``idx`` and keeps the stack's shared layout) as the
    port's, on the CPU; bf16 payload bytes cross as uint16."""
    lay = p.layout
    layout = TileSparseLayout(k=lay.k, n=lay.n, bk=lay.bk, bn=lay.bn,
                              dtype=lay.dtype, orig_dtype=lay.orig_dtype,
                              indptr=lay.indptr, indices=lay.indices,
                              trans_w=lay.trans_w, g=lay.g)
    payload = np.asarray(p.payload if idx is None else p.payload[idx])
    if layout.dtype == "bfloat16":
        tensor = torch.from_numpy(payload.view(np.uint16).copy()).view(
            torch.bfloat16)
    else:
        tensor = torch.from_numpy(payload.copy())
    if (dtype_name(tensor.dtype) != layout.dtype
            or tuple(tensor.shape) != layout.payload_shape):
        raise ValueError(f"sparse leaf {layout.describe()}: payload "
                         f"{tensor.dtype} {tuple(tensor.shape)}")
    scales = None
    if p.scales is not None:
        scales = torch.from_numpy(np.asarray(
            p.scales if idx is None else p.scales[idx],
            dtype=np.float32).copy())
    return TileSparseOperand(tensor, scales, layout)


def params_from_jax(np_params, cfg: ArchConfig) -> Dict[str, Any]:
    """The port's parameter dict from a reference pytree with numpy leaves
    (``jax.tree_util.tree_map(np.asarray, params)``), as CPU tensors: f32
    for dense leaves, and the port's ``PackedOperand`` / ``TileSparseOperand``
    for the reference's packed (``repro.packing.pack_params``) and sparse
    (``repro.sparse.sparsify_params``) ones, payload bytes unchanged, and
    a static int8 ``{"q", "scale"}`` dict (``repro.core.quantization.
    quantize_params``) as int8 ``q`` (a stacked leaf's sliced at the
    layer) and the stack's one shared f32 ``scale``.

    The reference keeps ``stack``, one dict per unit kind with a leading
    ``n_units`` axis, and ``tail``, a list; layer ``u * len(unit) + p`` is
    ``stack[p]`` at index ``u``, followed by the tail layers.  Its
    ``encoder`` is one dict with a leading ``encoder_layers`` axis.  Pass the
    result to :meth:`LM.load_params` for the device and the policy's casts.
    """
    def t(a, idx=None):
        if hasattr(a, "payload") and hasattr(a, "layout"):
            if hasattr(a.layout, "indptr"):
                return _sparse_from_jax(a, idx)
            return _packed_from_jax(a, idx)
        a = np.asarray(a) if idx is None else np.asarray(a)[idx]
        return torch.from_numpy(np.asarray(a, dtype=np.float32).copy())

    def quantized(d, idx=None):
        q = np.asarray(d["q"]) if idx is None else np.asarray(d["q"])[idx]
        return {"q": torch.from_numpy(np.asarray(q, dtype=np.int8).copy()),
                "scale": torch.from_numpy(np.asarray(d["scale"],
                                                     dtype=np.float32).copy())}

    def tree(d, idx=None):
        if is_quantized(d):
            return quantized(d, idx)
        return {k: (tree(v, idx) if isinstance(v, dict) else t(v, idx))
                for k, v in d.items()}

    unit, n_units, rem = segment_pattern(cfg.pattern)
    layers = [tree(np_params["stack"][p], u)
              for u in range(n_units) for p in range(len(unit))]
    layers += [tree(layer) for layer in np_params["tail"][:len(rem)]]
    out = {"embed": t(np_params["embed"]),
           "final_norm": tree(np_params["final_norm"]),
           "layers": layers}
    for name in ("head", "pos_embed", "enc_pos"):
        if name in np_params:
            out[name] = (quantized(np_params[name])
                         if is_quantized(np_params[name])
                         else t(np_params[name]))
    if "encoder" in np_params:
        out["encoder"] = [tree(np_params["encoder"], i)
                          for i in range(cfg.encoder_layers)]
        out["enc_norm"] = tree(np_params["enc_norm"])
    return out
