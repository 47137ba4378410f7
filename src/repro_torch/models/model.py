"""Attention + MoE decoders, Mamba hybrids, RWKV6 stacks and
encoder-decoders (the serving model), in PyTorch.

Port of ``repro.models.model.Model`` for stacks of GQA or MLA attention
blocks and Mamba blocks (Jamba's hybrid) with routed-MoE (optionally
shared-expert) or dense FFNs, of RWKV6 blocks (time-mix recurrence +
channel-mix), of Gemma-2's alternating sliding-window / global layers
(ring caches, softcaps), of M-RoPE (Qwen2-VL, over stub patch embeddings)
and of Whisper's bidirectional encoder with cross-attention in every
decoder layer and learned absolute positions (over stub frame
embeddings). The reference scans periodic layer groups; here the layers
are a ``ModuleList`` walked by a Python loop. ``split_periodic`` is kept so
that ``params.from_reference`` can unstack the reference's scan-group
axis.

Entry points (all under ``torch.inference_mode()`` when serving)
  init(seed)                                      -> self
  trainable(flag=True)                            -> self
  forward(batch, capacity_factor=, remat=)        -> (logits, aux)
  loss(batch, capacity_factor=, remat=True)       -> scalar (LM + MoE aux)
  init_cache(B, cache_len, decode_window=0)       -> cache (zeros)
  prefill(batch, cache, true_len=...)             -> (last_logits, cache, aux)
  serve_step(cache, token_or_embeds, decode_window=0, active=...)
                                                  -> (logits, cache, aux)

``batch`` holds ``tokens`` (B, S) or ``embeds`` (B, S, d), optionally
``positions`` ((3, B, S) under M-RoPE), and ``enc_embeds`` (B, S_enc, d)
for an encoder-decoder.

``aux["counts"]`` is (n_moe_layers, B, E) int32: the rows of the paper's
Expert Activation Matrix, equal to the reference's (None without MoE).

``Model(cfg, device="meta")`` builds the parameters without memory and
without ``init``: the dry run (``launch/dryrun.py``) traces the entry
points over meta tensors, where each kernel is a stand-in that counts its
launch (``kernels.meta``).
"""
from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
from torch import nn
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts,
                                    noop_context_fn)

from repro_torch import resolve_device
from repro_torch.config import ArchConfig, BLOCK_ATTN, BLOCK_MAMBA, BLOCK_RWKV
from repro_torch.models.attention import (MLA, Attention, attn_decode,
                                          attn_forward, cross_kv, mla_decode,
                                          mla_forward)
from repro_torch.models.layers import FFN, Norm, apply_ffn, softcap
from repro_torch.models.mamba import Mamba, _dims, mamba_decode, mamba_forward
from repro_torch.models.moe import MoE, moe_ffn
from repro_torch.models.rwkv6 import RWKV, rwkv_channel_mix, rwkv_time_mix


@dataclass(frozen=True)
class LayerDesc:
    kind: str          # attn | mamba | rwkv
    is_moe: bool
    window: int        # sliding window for this layer (0 = full)


def layer_descs(cfg: ArchConfig):
    out = []
    for i in range(cfg.n_layers):
        kind = cfg.block_kind(i)
        win = cfg.attn.sliding_window if cfg.is_local_attn_layer(i) else 0
        out.append(LayerDesc(kind, cfg.is_moe_layer(i), win))
    return out


def split_periodic(descs):
    """-> (n_prefix, period): tail [n_prefix:] is periodic with ``period``.

    The reference's choice of scan groups: the split with the most groups,
    ties to the shortest prefix; no periodic tail of >= 2 groups means
    prefix only."""
    n = len(descs)
    best = (n, 1)
    best_groups = 1 if n else 0
    for prefix in range(0, n):
        m = n - prefix
        for period in range(1, m):
            if m % period:
                continue
            if all(descs[prefix + i] == descs[prefix + i % period]
                   for i in range(m)):
                groups = m // period
                if groups > best_groups:
                    best, best_groups = (prefix, period), groups
                break  # smallest period at this prefix is its best
    if best == (n, 1) and n:
        return n, 1
    return best


# the encoder's blocks: full (bidirectional) attention and a dense FFN
ENCODER_DESC = LayerDesc(BLOCK_ATTN, False, 0)


def _save_dots(ctx, func, *args, **kwargs):
    """Selective remat under ``remat_policy == "dots"``: keep the outputs
    of matrix products with no batch dims (the reference's
    ``dots_with_no_batch_dims_saveable``; torch's einsum runs those as
    ``bmm`` over a batch of one) and recompute the rest."""
    aten = torch.ops.aten
    dot = func in (aten.mm.default, aten.addmm.default) or (
        func == aten.bmm.default and args[0].shape[0] == 1)
    return (CheckpointPolicy.MUST_SAVE if dot
            else CheckpointPolicy.PREFER_RECOMPUTE)


class Block(nn.Module):
    def __init__(self, cfg: ArchConfig, desc: LayerDesc, dtype, device,
                 cross: bool = False):
        super().__init__()
        d = cfg.d_model
        self.norm1 = Norm(cfg.norm, d, device)
        if desc.kind == BLOCK_RWKV:      # its channel-mix is the FFN half
            self.rwkv = RWKV(cfg, dtype, device)
        elif desc.kind == BLOCK_MAMBA:
            self.mamba = Mamba(cfg, dtype, device)
        elif cfg.attn.mla is not None:
            self.attn = MLA(cfg, dtype, device)
        else:
            self.attn = Attention(cfg, dtype, device)
        self.norm2 = Norm(cfg.norm, d, device)
        if desc.is_moe:
            self.moe = MoE(cfg, dtype, device)
        elif desc.kind != BLOCK_RWKV:
            self.ffn = FFN(cfg, cfg.d_ff, dtype, device)
        if cfg.post_block_norm:
            self.post_norm1 = Norm(cfg.norm, d, device)
            self.post_norm2 = Norm(cfg.norm, d, device)
        if cross:         # a decoder block of an encoder-decoder
            self.cross_attn = Attention(cfg, dtype, device)
            self.norm_cross = Norm(cfg.norm, d, device)


class Model(nn.Module):
    def __init__(self, cfg: ArchConfig, device="cuda"):
        super().__init__()
        self.device = resolve_device(device)
        self.cfg = cfg
        self.descs = layer_descs(cfg)
        self.n_prefix, self.period = split_periodic(self.descs)
        self.n_groups = (cfg.n_layers - self.n_prefix) // self.period
        self.dtype = getattr(torch, cfg.dtype)
        self.moe_layers = [i for i, d in enumerate(self.descs) if d.is_moe]
        d, V, dev = cfg.d_model, cfg.vocab, self.device
        self.embed = nn.Parameter(torch.empty(V, d, dtype=self.dtype,
                                              device=dev), requires_grad=False)
        self.final_norm = Norm(cfg.norm, d, dev)
        self.stds = {"embed": d ** -0.5}
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(d, V, dtype=self.dtype,
                                                    device=dev),
                                        requires_grad=False)
            self.stds["lm_head"] = d ** -0.5
        enc_dec = cfg.is_encoder_decoder
        self.layers = nn.ModuleList(
            Block(cfg, desc, self.dtype, dev,
                  cross=enc_dec and desc.kind == BLOCK_ATTN)
            for desc in self.descs)

        def table(rows):
            return nn.Parameter(torch.empty(rows, d, dtype=self.dtype,
                                            device=dev), requires_grad=False)
        if not cfg.attn.use_rope:            # learned absolute positions
            self.pos_embed = table(cfg.max_seq_len)
            self.stds["pos_embed"] = d ** -0.5
        if enc_dec:
            self.enc_pos_embed = table(cfg.encoder_seq_len)
            self.stds["enc_pos_embed"] = d ** -0.5
            self.encoder = nn.ModuleList(
                Block(cfg, ENCODER_DESC, self.dtype, dev)
                for _ in range(cfg.n_encoder_layers))
            self.enc_final_norm = Norm(cfg.norm, d, dev)

    # -- init -----------------------------------------------------------------
    @torch.no_grad()
    def init(self, seed: int = 0):
        """Draw every weight from one seeded ``torch.Generator`` on the
        model's device, with the reference's shapes, dtypes and stds (the
        numbers differ from ``jax.random``'s). Norm scales are ones, biases
        zeros. Returns self."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for mod in self.modules():
            for name, std in getattr(mod, "stds", {}).items():
                w = getattr(mod, name)
                # row blocks of <= 2^26 elements bound the fp32 staging
                rows = max(1, (1 << 26) // max(1, w[0].numel()))
                for i in range(0, w.shape[0], rows):
                    blk = w[i:i + rows]
                    blk.copy_(torch.randn(blk.shape, generator=gen,
                                          device=self.device) * std)
        return self

    def trainable(self, flag: bool = True):
        """Set ``requires_grad`` on every parameter (built off, for
        serving). Returns self."""
        for p in self.parameters():
            p.requires_grad_(flag)
        return self

    # -- full-sequence blocks -------------------------------------------------
    def _apply_block_pre(self, p: Block, desc: LayerDesc, x, positions,
                         enc_kv=None):
        """Mixer half (then cross-attention over ``enc_kv``, the layer's
        projected encoder K/V, in an encoder-decoder). Returns (x_mid, h2,
        aux): aux["kv"] = (k, v) for GQA, (c_kv, k_rope) for MLA, and
        aux["cross_kv"] = ``enc_kv``; aux["mamba_state"] and
        aux["mamba_conv"] (the last d_conv - 1 conv inputs) for mamba;
        aux["rwkv_state"] and aux["rwkv_tm"] (the last normed block input)
        for rwkv: what prefill seeds the cache with (``_seed_mixer``)."""
        h = p.norm1(x)
        if desc.kind == BLOCK_RWKV:
            y, (state, last_tm) = rwkv_time_mix(p.rwkv, self.cfg, h)
            aux = {"rwkv_state": state, "rwkv_tm": last_tm}
        elif desc.kind == BLOCK_MAMBA:
            y, state, conv = mamba_forward(p.mamba, self.cfg, h)
            aux = {"mamba_state": state, "mamba_conv": conv}
        elif self.cfg.attn.mla is not None:
            y, kv = mla_forward(p.attn, self.cfg, h, positions)
            aux = {"kv": kv}
        else:
            y, kv = attn_forward(p.attn, self.cfg, h, positions,
                                 window=desc.window)
            aux = {"kv": kv}
        if self.cfg.post_block_norm:
            y = p.post_norm1(y)
        x = x + y
        if enc_kv is not None:
            yc, _ = attn_forward(p.cross_attn, self.cfg, p.norm_cross(x),
                                 positions, kv=enc_kv)
            x = x + yc
            aux["cross_kv"] = enc_kv
        return x, p.norm2(x), aux

    def _apply_block_post(self, p: Block, desc: LayerDesc, x_mid, h2, *,
                          capacity_factor=None, expert_fn=None,
                          token_mask=None, routing=None, slot_weights=None,
                          slot_ids=None):
        """FFN half. Returns (x_out, aux) with MoE counts/aux_loss, or with
        aux["rwkv_cm"] (the last h2 row: rwkv's channel-mix shift).
        ``expert_fn``/``routing``/``slot_weights``/``slot_ids``: see
        ``moe.moe_ffn``."""
        aux = {}
        if desc.kind == BLOCK_RWKV:
            y2, _ = rwkv_channel_mix(p.rwkv, self.cfg, h2)
            aux["rwkv_cm"] = h2[:, -1]
        elif desc.is_moe:
            y2, moe_aux = moe_ffn(p.moe, self.cfg, h2,
                                  capacity_factor=capacity_factor,
                                  expert_fn=expert_fn,
                                  token_mask=token_mask, routing=routing,
                                  slot_weights=slot_weights,
                                  slot_ids=slot_ids)
            aux.update(moe_aux)
        else:
            y2 = apply_ffn(p.ffn, h2, self.cfg.act)
        if self.cfg.post_block_norm:
            y2 = p.post_norm2(y2)
        return x_mid + y2, aux

    def _embed(self, batch):
        """``batch``'s tokens (B, S), or its ``embeds`` (B, S, d), -> (x,
        positions): ``batch["positions"]`` if given, else 0..S-1 per row,
        broadcast to (3, B, S) under M-RoPE; learned absolute positions
        add their table's rows (the temporal plane's under M-RoPE)."""
        cfg = self.cfg
        if "embeds" in batch:
            x = batch["embeds"].to(self.dtype)
        else:
            x = self.embed[batch["tokens"]]
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=self.dtype)
        B, S = x.shape[:2]
        positions = batch.get("positions")
        if positions is None:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
            if cfg.attn.mrope_sections:
                positions = positions.expand(3, B, S)
        if not cfg.attn.use_rope:
            x = x + self.pos_embed[positions if positions.dim() == 2
                                   else positions[0]]
        return x, positions

    def _embed_step(self, token_or_embeds, pos):
        """(B,) decode tokens, or (B, 1, d) embeddings, at the per-slot
        positions ``pos`` -> (B, 1, d)."""
        cfg = self.cfg
        if token_or_embeds.dim() == 1:
            x = self.embed[token_or_embeds][:, None]
        else:
            x = token_or_embeds.to(self.dtype)
        if cfg.embed_scale:
            x = x * torch.tensor(cfg.d_model ** 0.5, dtype=self.dtype)
        if not cfg.attn.use_rope:
            x = x + self.pos_embed[pos][:, None]
        return x

    def _encode(self, enc_embeds):
        """Whisper's bidirectional encoder over stub frame embeddings (B,
        encoder_seq_len, d) -> the normed encoder output."""
        cfg = self.cfg
        x = enc_embeds.to(self.dtype) + self.enc_pos_embed[None]
        B, S = x.shape[:2]
        positions = torch.arange(S, dtype=torch.int32,
                                 device=x.device).expand(B, S)
        mask = torch.zeros((1, 1, S, S), device=x.device)
        for p in self.encoder:
            y, _ = attn_forward(p.attn, cfg, p.norm1(x), positions,
                                mask=mask)
            x = x + y
            x = x + apply_ffn(p.ffn, p.norm2(x), cfg.act)
        return self.enc_final_norm(x)

    def _cross_kvs(self, batch):
        """Per decoder layer, the projected encoder K/V of
        ``batch["enc_embeds"]`` (None for other layers and for a
        decoder-only model)."""
        if not self.cfg.is_encoder_decoder:
            return [None] * len(self.layers)
        enc_out = self._encode(batch["enc_embeds"])
        return [cross_kv(p.cross_attn, self.cfg, enc_out)
                if hasattr(p, "cross_attn") else None for p in self.layers]

    @staticmethod
    def _store_kv(bc, kv, rows=slice(None)):
        """Write a prefill's full-sequence (k, v), or MLA's (c_kv, k_rope),
        into cache rows ``rows``. A prompt longer than the cache leaves its
        last L positions, position p at ``p % L`` as a ring (window) cache
        keeps it; the reference writes them from 0 (its prefill asks that a
        prompt fit the window), which is the same for S <= L. A right-padded
        prompt longer than a ring would put pad rows in it: prefill such a
        prompt at its exact length."""
        keys = ("ckv", "kr") if "ckv" in bc else ("k", "v")
        for key, full in zip(keys, kv):
            S, L = full.shape[1], bc[key].shape[1]
            if S <= L:
                bc[key][rows, :S] = full.to(bc[key].dtype)
            else:
                bc[key][rows] = torch.roll(full[:, S - L:], S % L,
                                           dims=1).to(bc[key].dtype)

    def _seed_mixer(self, bc, desc: LayerDesc, aux, rows=slice(None)):
        """Write a prefill's mixer state (``_apply_block_pre``'s aux) into
        cache rows ``rows``: attention K/V (or MLA latent) rows, mamba's
        conv tail and final state, rwkv's state and time-mix shift. rwkv's
        channel-mix shift comes from the FFN half; the caller seeds it."""
        if desc.kind == BLOCK_ATTN:
            self._store_kv(bc, aux["kv"], rows)
            if "cross_kv" in aux:
                bc["cross_k"][rows] = aux["cross_kv"][0].to(self.dtype)
                bc["cross_v"][rows] = aux["cross_kv"][1].to(self.dtype)
            return
        keys = ({"conv": "mamba_conv", "ssm": "mamba_state"}
                if desc.kind == BLOCK_MAMBA
                else {"state": "rwkv_state", "tm": "rwkv_tm"})
        for key, name in keys.items():
            bc[key][rows] = aux[name].to(bc[key].dtype)

    def _logits(self, x):
        head = self.embed.T if self.cfg.tie_embeddings else self.lm_head
        logits = (x @ head.to(x.dtype)).float()
        return softcap(logits, self.cfg.final_logit_softcap)

    # -- public: forward ------------------------------------------------------
    def _apply_block(self, p: Block, desc: LayerDesc, x, positions, enc_kv,
                     capacity_factor, expert_fn=None):
        x_mid, h2, _ = self._apply_block_pre(p, desc, x, positions, enc_kv)
        return self._apply_block_post(p, desc, x_mid, h2,
                                      capacity_factor=capacity_factor,
                                      expert_fn=expert_fn)

    def forward(self, batch, *, capacity_factor=None, remat=False,
                expert_fn=None):
        """Full-sequence forward of ``batch`` (see the module docstring).
        ``capacity_factor`` sizes the MoE capacity (default: the config's).
        ``remat``: recompute, in the backward, each layer of the periodic
        tail (the reference's scan groups; prefix layers keep their
        activations), all of it under ``remat_policy == "full"``, all but
        the unbatched matrix products under ``"dots"``. ``expert_fn``: see
        ``moe.moe_ffn``. Returns (logits (B,S,V) fp32, {"counts":
        (n_moe,B,E) or None, "aux_loss"})."""
        x, positions = self._embed(batch)
        ctx = (functools.partial(create_selective_checkpoint_contexts,
                                 _save_dots)
               if self.cfg.remat_policy == "dots" else noop_context_fn)
        counts, losses = [], []
        for i, (p, desc, ekv) in enumerate(zip(self.layers, self.descs,
                                               self._cross_kvs(batch))):
            args = (p, desc, x, positions, ekv, capacity_factor, expert_fn)
            if remat and i >= self.n_prefix:
                x, aux = checkpoint(self._apply_block, *args,
                                    use_reentrant=False, context_fn=ctx)
            else:
                x, aux = self._apply_block(*args)
            if "counts" in aux:
                counts.append(aux["counts"])
                losses.append(aux["aux_loss"])
        logits = self._logits(self.final_norm(x))
        aux_loss = (torch.stack(losses).sum() if losses
                    else torch.zeros((), device=x.device))
        return logits, {"counts": torch.stack(counts) if counts else None,
                        "aux_loss": aux_loss}

    def loss(self, batch, *, capacity_factor=None, remat=True):
        """Next-token LM loss + MoE load-balance aux: over ``batch["labels"]``
        when given, else each position predicts the next token."""
        logits, aux = self.forward(batch, capacity_factor=capacity_factor,
                                   remat=remat)
        if "labels" in batch:
            labels, lg = batch["labels"], logits
        else:
            labels, lg = batch["tokens"][:, 1:], logits[:, :-1]
        lp = torch.log_softmax(lg, dim=-1)
        nll = -torch.gather(lp, -1, labels[..., None].long())[..., 0]
        return nll.mean() + aux["aux_loss"]

    # -- caches ---------------------------------------------------------------
    def init_cache(self, B: int, cache_len: int, decode_window: int = 0):
        """Zeroed decode cache: ``pos`` is a (B,) per-slot position vector,
        ``layers`` one dict per layer: {"k", "v"} of (B, L, Hkv, hd) for
        GQA, plus {"cross_k", "cross_v"} of (B, encoder_seq_len, Hkv, hd)
        in an encoder-decoder; {"ckv" (B, L, kv_lora_rank), "kr" (B, L,
        qk_rope_head_dim)} for MLA; for mamba {"conv" (B, d_conv - 1,
        d_in), the last conv inputs, "ssm" (B, d_in, N) fp32}; for rwkv
        {"state" (B, H, hd, hd) fp32, "tm" and "cm" (B, d)}, the
        token-shift inputs of time- and channel-mix (recurrent layers take
        no ``cache_len``: their state is constant in context length).
        L = ``cache_len``, or ``min(cache_len, window)`` for a
        sliding-window layer, and for every attention layer when
        ``decode_window`` is set: a ring buffer of that many positions
        (pass the same ``decode_window`` to ``serve_step``)."""
        cfg = self.cfg

        def zeros(*shape, dtype=self.dtype):
            return torch.zeros(shape, dtype=dtype, device=self.device)

        def layer(desc):
            if desc.kind == BLOCK_RWKV:
                hd = cfg.rwkv.head_dim
                return {"state": zeros(B, cfg.d_model // hd, hd, hd,
                                       dtype=torch.float32),
                        "tm": zeros(B, cfg.d_model),
                        "cm": zeros(B, cfg.d_model)}
            if desc.kind == BLOCK_MAMBA:
                d_in, _ = _dims(cfg)
                return {"conv": zeros(B, cfg.mamba.d_conv - 1, d_in),
                        "ssm": zeros(B, d_in, cfg.mamba.d_state,
                                     dtype=torch.float32)}
            win = desc.window or decode_window
            L = min(cache_len, win) if win else cache_len
            m = cfg.attn.mla
            if m is not None:
                return {"ckv": zeros(B, L, m.kv_lora_rank),
                        "kr": zeros(B, L, m.qk_rope_head_dim)}
            kv = (B, L, cfg.n_kv_heads, cfg.head_dim_)
            c = {"k": zeros(*kv), "v": zeros(*kv)}
            if cfg.is_encoder_decoder:
                cross = (B, cfg.encoder_seq_len, cfg.n_kv_heads,
                         cfg.head_dim_)
                c.update(cross_k=zeros(*cross), cross_v=zeros(*cross))
            return c

        return {"pos": zeros(B, dtype=torch.int32),
                "layers": [layer(desc) for desc in self.descs]}

    def write_slot(self, pool, one, slot: int):
        """Copy a B=1 cache ``one`` into row ``slot`` of the pooled cache
        (same cache_len), in place; the other slots are untouched."""
        pool["pos"][slot] = one["pos"][0]
        for pl, ol in zip(pool["layers"], one["layers"]):
            for key in pl:
                pl[key][slot] = ol[key][0]
        return pool

    # -- decode-path block ----------------------------------------------------
    @staticmethod
    def _ring(cache_phys_len: int, win: int) -> bool:
        """Whether an attention cache of this length is a ring over the
        window ``win`` (as the reference's ``_ring`` decides)."""
        return bool(win) and cache_phys_len <= win

    def _decode_block_pre(self, p: Block, desc: LayerDesc, bc, x, pos,
                          active=None, decode_window: int = 0):
        """Mixer half of one-token decode (norm1 -> attention over the
        cache, or mamba / rwkv time-mix from its state -> cross-attention
        over the encoder's K/V in an encoder-decoder -> norm2). The new
        K/V (or MLA latent) rows are written in place, for active slots
        only, at ``pos`` or, in a ring cache, at ``pos % L``; mamba's new
        "conv"/"ssm" and rwkv's new "state"/"tm" replace the old ones on
        active rows only. Returns (x_mid, h2, bc)."""
        win = desc.window or decode_window
        h = p.norm1(x)
        if desc.kind == BLOCK_RWKV:
            y, (state, tm) = rwkv_time_mix(p.rwkv, self.cfg, h, bc["state"],
                                           bc["tm"])
            _gate_into(bc, active, state=state, tm=tm)
        elif desc.kind == BLOCK_MAMBA:
            y, conv, ssm = mamba_decode(p.mamba, self.cfg, h, bc["conv"],
                                        bc["ssm"])
            _gate_into(bc, active, conv=conv, ssm=ssm)
        elif self.cfg.attn.mla is not None:
            y, bc["ckv"], bc["kr"] = mla_decode(
                p.attn, self.cfg, h, bc["ckv"], bc["kr"], pos, active=active,
                ring=self._ring(bc["ckv"].shape[1], win))
        else:
            y, bc["k"], bc["v"] = attn_decode(
                p.attn, self.cfg, h, bc["k"], bc["v"], pos, active=active,
                ring=self._ring(bc["k"].shape[1], win))
        if self.cfg.post_block_norm:
            y = p.post_norm1(y)
        x = x + y
        if "cross_k" in bc:
            yc, _, _ = attn_decode(p.cross_attn, self.cfg, p.norm_cross(x),
                                   bc["cross_k"], bc["cross_v"], pos,
                                   cross=True)
            x = x + yc
        return x, p.norm2(x), bc

    def _decode_block_post(self, p: Block, desc: LayerDesc, x_mid, h2, *,
                           bc=None, expert_fn=None, active=None, routing=None,
                           slot_weights=None, slot_ids=None):
        """FFN half of one-token decode. Returns (x_out, counts or None).
        rwkv reads its channel-mix shift from the block cache ``bc`` and
        replaces ``bc["cm"]`` on ``active`` rows (all when None).
        ``expert_fn``/``routing``/``slot_weights``/``slot_ids``: see
        ``moe.moe_ffn``."""
        cfg = self.cfg
        counts = None
        if desc.kind == BLOCK_RWKV:
            y2, cm = rwkv_channel_mix(p.rwkv, cfg, h2, bc["cm"])
            _gate_into(bc, active, cm=cm)
        elif desc.is_moe:
            # dropless (C >= T) by default: an inactive slot's token can
            # never displace an active one's
            cf = (cfg.decode_capacity_factor
                  or cfg.moe.n_experts / cfg.moe.top_k)
            y2, aux = moe_ffn(p.moe, cfg, h2, capacity_factor=cf,
                              expert_fn=expert_fn, routing=routing,
                              slot_weights=slot_weights,
                              slot_ids=slot_ids)
            counts = aux["counts"]
        else:
            y2 = apply_ffn(p.ffn, h2, cfg.act)
        if cfg.post_block_norm:
            y2 = p.post_norm2(y2)
        return x_mid + y2, counts

    # -- public: prefill / serve_step -----------------------------------------
    def prefill(self, batch, cache, *, expert_fn=None, true_len=None):
        """Run the prompt, fill ``cache`` (in place), return last-token
        logits. ``true_len``: optional per-row real prompt length for a
        right-padded prompt: pad tokens are causally invisible to real
        ones, take no MoE capacity, add no counts, and the logits come from
        each row's last real token. As in the reference, recurrent (mamba,
        rwkv) state is not pad-corrected: prefill those at exact lengths.
        ``expert_fn``: see ``moe.moe_ffn``. Returns (logits (B,V), cache,
        aux)."""
        x, positions = self._embed(batch)
        B, S = x.shape[:2]
        token_mask = None
        if true_len is not None:
            # torch-lint: disable=capture-hazard -- the servers pass a (B,) int32 tensor on the device, which as_tensor returns as it is; a host int or array is copied, so a captured prefill must take the tensor form
            true_len = torch.as_tensor(true_len, dtype=torch.int32,
                                       device=x.device).expand(B)
            token_mask = (torch.arange(S, device=x.device)[None, :]
                          < true_len[:, None])
        counts = []
        for p, desc, bc, ekv in zip(self.layers, self.descs, cache["layers"],
                                    self._cross_kvs(batch)):
            x_mid, h2, aux = self._apply_block_pre(p, desc, x, positions,
                                                   ekv)
            x, aux_ffn = self._apply_block_post(p, desc, x_mid, h2,
                                                capacity_factor=2.0,
                                                expert_fn=expert_fn,
                                                token_mask=token_mask)
            self._seed_mixer(bc, desc, aux)
            if desc.kind == BLOCK_RWKV:
                bc["cm"].copy_(aux_ffn["rwkv_cm"])
            if "counts" in aux_ffn:
                counts.append(aux_ffn["counts"])
        if true_len is None:
            cache["pos"] = torch.full((B,), S, dtype=torch.int32,
                                      device=x.device)
            x_last = x[:, -1:]
        else:
            cache["pos"] = true_len.clone()
            idx = (true_len.long() - 1)[:, None, None].expand(B, 1,
                                                             x.shape[-1])
            x_last = torch.gather(x, 1, idx)
        logits = self._logits(self.final_norm(x_last))[:, 0]
        return logits, cache, {
            "counts": torch.stack(counts) if counts else None}

    def serve_step(self, cache, token_or_embeds, *, expert_fn=None,
                   decode_window: int = 0, active=None):
        """One decode step for ``token_or_embeds`` ((B,) tokens or (B, 1,
        d) embeddings) at the per-slot positions ``cache["pos"]``.
        ``decode_window``: the one the cache was made with. ``active``:
        optional (B,) bool mask; inactive slots are computed (fixed batch
        shape) but their cache rows, position and counts stay untouched.
        ``expert_fn``: see ``moe.moe_ffn``. Returns (logits (B,V), cache,
        aux)."""
        pos = cache["pos"]
        x = self._embed_step(token_or_embeds, pos)
        counts = []
        for p, desc, bc in zip(self.layers, self.descs, cache["layers"]):
            x_mid, h2, bc = self._decode_block_pre(
                p, desc, bc, x, pos, active=active,
                decode_window=decode_window)
            x, cnt = self._decode_block_post(p, desc, x_mid, h2, bc=bc,
                                             expert_fn=expert_fn,
                                             active=active)
            if cnt is not None:
                counts.append(cnt)
        cache["pos"] = (pos + 1 if active is None
                        else _gate_rows(active, pos + 1, pos))
        logits = self._logits(self.final_norm(x))[:, 0]
        counts = torch.stack(counts) if counts else None
        if counts is not None and active is not None:
            counts = counts * active.to(counts.dtype)[None, :, None]
        return logits, cache, {"counts": counts}


def _gate_rows(active, new, old):
    """Per-row select: keep ``old`` rows where ``active`` is False."""
    a = active.reshape((-1,) + (1,) * (new.dim() - 1))
    return torch.where(a, new, old)


def _gate_into(bc, active, **new):
    """Replace block-cache entries with ``new``, keeping the old rows where
    ``active`` is False (all rows replaced when ``active`` is None)."""
    for key, val in new.items():
        bc[key] = val if active is None else _gate_rows(active, val, bc[key])
