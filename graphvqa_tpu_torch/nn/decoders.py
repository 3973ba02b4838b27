"""Program and full-answer decoders (port of ``graphvqa_tpu/nn/decoders.py``):
the teacher-forced training paths (``forward``) and greedy sampling
(``sample``).

The program decoder is two-stage: M learned queries cross-attend to the
question memory (the coarse stage, giving the instruction vectors), then the
fine stage decodes the M instruction streams, where position 0 is the
instruction vector itself. Teacher-forced, the M streams of a question are
packed into one M*L sequence under ``block_causal_mask``. Sampling is a
KV-cached greedy decode whose cross-attention K/V are projected once per
question and shared by its M streams (``memory_group``); the JAX package runs
it as ``lax.scan`` to dodge a TPU miscompile, here it is a plain Python loop
over the cache. ``generator=None`` is deterministic; sampling always is.
"""
from __future__ import annotations

import math

import torch
from torch import nn

from graphvqa_tpu_torch.nn.embedding import PaddedEmbed
from graphvqa_tpu_torch.nn.transformer import (
    PositionalEncoding, TorchLinear, TransformerDecoder, block_causal_mask,
    causal_mask)


def _greedy_token(logits: torch.Tensor, pad_idx: int,
                  sos_idx: int) -> torch.Tensor:
    """Argmax over emittable tokens: ``<pad>`` and ``<start>`` are never a
    supervised target, so their logits are masked to the dtype's minimum
    before the argmax (``<unk>`` stays emittable)."""
    logits = logits.clone()
    neg = torch.finfo(logits.dtype).min
    logits[..., pad_idx].fill_(neg)
    logits[..., sos_idx].fill_(neg)
    return logits.argmax(dim=-1).to(torch.int32)


class _GreedyDecoder(nn.Module):
    """Shared embedding step of both samplers."""

    def __init__(self, emb_dim, hidden_dim, vocab_size, dtype, dropout):
        super().__init__()
        self.hidden_dim = hidden_dim
        self.emb_proj = TorchLinear(emb_dim, hidden_dim, dtype=dtype)
        self.pos_encoder = PositionalEncoding(hidden_dim, dropout=dropout)
        self.vocab_decoder = TorchLinear(hidden_dim, vocab_size, dtype=dtype)

    def _embed(self, tokens, text_embed: PaddedEmbed, generator):
        """Embedding of a whole token stream [R, L] -> [R, L, D]."""
        x = self.emb_proj(text_embed(tokens)) * math.sqrt(self.hidden_dim)
        return self.pos_encoder(x, generator)

    def _embed_step(self, tokens, text_embed: PaddedEmbed, t: int):
        """Embedding of one position ``t`` for tokens [B] -> [B, D]."""
        x = self.emb_proj(text_embed(tokens)) * math.sqrt(self.hidden_dim)
        return x + self.pos_encoder.pe[t].to(x.dtype)


class ProgramDecoder(_GreedyDecoder):
    def __init__(self, emb_dim: int, vocab_size: int, num_queries: int = 5,
                 hidden_dim: int = 512, num_heads: int = 8, ffn_dim: int = 2048,
                 num_layers: int = 3, sos_idx: int = 2, pad_idx: int = 1,
                 max_decode_len: int = 16, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__(emb_dim, hidden_dim, vocab_size, dtype, dropout)
        self.num_queries, self.max_decode_len = num_queries, max_decode_len
        self.sos_idx, self.pad_idx = sos_idx, pad_idx
        self.query_embed = nn.Embedding(num_queries, hidden_dim)
        self.coarse_decoder = TransformerDecoder(
            num_layers, hidden_dim, num_heads, ffn_dim, dtype, dropout)
        self.transformer_decoder = TransformerDecoder(   # the fine stage
            num_layers, hidden_dim, num_heads, ffn_dim, dtype, dropout)

    def _instruction_vectors(self, memory, generator=None):
        """Coarse stage -> (instr [M, B, D], flat [B*M, D] in b-major order,
        matching the 5x flattened program stream)."""
        B, M, D = memory.shape[0], self.num_queries, self.hidden_dim
        queries = self.query_embed.weight[None].expand(B, M, D)
        instr = self.coarse_decoder(queries, memory,
                                    generator=generator)         # [B, M, D]
        return instr.transpose(0, 1), instr.reshape(B * M, D)

    def forward(self, memory, tgt, text_embed: PaddedEmbed, generator=None):
        """Teacher-forced decode: memory [B, Lq, D], tgt [B*M, L] input
        tokens -> (logits [B*M, L, V], instruction vectors [M, B, D]). The
        <start> slot's embedding is replaced by the instruction vector, and
        the M streams of a question run as one M*L sequence under a
        block-causal mask."""
        instr_mbd, instr_flat = self._instruction_vectors(memory, generator)
        x = self._embed(tgt, text_embed, generator)
        x = torch.cat([instr_flat[:, None, :].to(x.dtype), x[:, 1:]], dim=1)
        BM, L, D = x.shape
        M = self.num_queries
        mask = block_causal_mask(M, L, device=x.device)
        out = self.transformer_decoder(x.reshape(BM // M, M * L, D), memory,
                                       tgt_mask=mask, generator=generator)
        return self.vocab_decoder(out.reshape(BM, L, D)), instr_mbd

    def sample(self, memory, text_embed: PaddedEmbed):
        """Greedy decode to ``max_decode_len`` -> (tokens [B*M, T] with
        position 0 = <start>, instruction vectors [M, B, D])."""
        instr_mbd, instr_flat = self._instruction_vectors(memory)
        T, BM = self.max_decode_len, instr_flat.shape[0]
        dec = self.transformer_decoder
        buf = torch.full((BM, T), self.sos_idx, dtype=torch.int32,
                         device=memory.device)
        cache = dec.init_cache(BM, T - 1, device=memory.device)
        cross_kvs = dec.precompute_cross_kv(memory)
        for t in range(1, T):
            if t == 1:   # position 0 is the raw instruction vector
                x_t = instr_flat.to(dec.compute_dtype)
            else:
                x_t = self._embed_step(buf[:, t - 1], text_embed, t - 1)
            out, cache = dec.decode_step(x_t, cache, cross_kvs, t - 1,
                                         memory_group=self.num_queries)
            buf[:, t] = _greedy_token(self.vocab_decoder(out), self.pad_idx,
                                      self.sos_idx)
        return buf, instr_mbd


class FullAnswerDecoder(_GreedyDecoder):
    def __init__(self, emb_dim: int, vocab_size: int, hidden_dim: int = 512,
                 num_heads: int = 8, ffn_dim: int = 2048, num_layers: int = 3,
                 sos_idx: int = 2, pad_idx: int = 1, max_decode_len: int = 20,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__(emb_dim, hidden_dim, vocab_size, dtype, dropout)
        self.max_decode_len = max_decode_len
        self.sos_idx, self.pad_idx = sos_idx, pad_idx
        self.transformer_decoder = TransformerDecoder(
            num_layers, hidden_dim, num_heads, ffn_dim, dtype, dropout)

    def forward(self, memory, tgt, text_embed: PaddedEmbed, generator=None):
        """Teacher-forced decode: tgt [B, L] input tokens -> logits
        [B, L, V] under a causal mask."""
        x = self._embed(tgt, text_embed, generator)
        mask = causal_mask(tgt.shape[1], device=x.device)
        out = self.transformer_decoder(x, memory, tgt_mask=mask,
                                       generator=generator)
        return self.vocab_decoder(out)

    def sample(self, memory, text_embed: PaddedEmbed):
        """Greedy decode -> tokens [B, T] (position 0 = <start>)."""
        T, B = self.max_decode_len, memory.shape[0]
        dec = self.transformer_decoder
        buf = torch.full((B, T), self.sos_idx, dtype=torch.int32,
                         device=memory.device)
        cache = dec.init_cache(B, T - 1, device=memory.device)
        cross_kvs = dec.precompute_cross_kv(memory)
        for t in range(1, T):
            x_t = self._embed_step(buf[:, t - 1], text_embed, t - 1)
            out, cache = dec.decode_step(x_t, cache, cross_kvs, t - 1)
            buf[:, t] = _greedy_token(self.vocab_decoder(out), self.pad_idx,
                                      self.sos_idx)
        return buf
