"""Post-LN transformer stacks (port of ``graphvqa_tpu/nn/transformer.py``).

Parameters carry the reference torch names (``in_proj_weight`` packing q, k
and v; ``multihead_attn`` for cross attention; ``layers.i`` and a final
``norm`` per stack), so a reference checkpoint loads with a plain
``load_state_dict``. The arithmetic follows the JAX package where bf16
rounds: linear layers compute in ``dtype``; attention scores, softmax and the
weighted sum run in float32 over ``dtype``-rounded operands; LayerNorm takes
float32 statistics (E[x^2] - E[x]^2, as flax does) and returns ``dtype``.

Dropout sits where the JAX package puts it: on the attention weights after
the softmax, on each sublayer's output before its residual add, inside the
feed-forward block after the ReLU, and after the positional encoding. Every
``forward`` takes ``generator``, a ``torch.Generator`` on the tensors'
device; ``None`` means deterministic (no dropout). The KV-cached greedy
decode (``init_cache`` / ``precompute_cross_kv`` / ``decode_step``) is
deterministic and updates its cache buffers in place.
"""
from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from graphvqa_tpu_torch.ops.row_layer_norm import layer_norm

KV = Tuple[torch.Tensor, torch.Tensor]


def matmul_f32(a: torch.Tensor, b: torch.Tensor,
               dtype: torch.dtype) -> torch.Tensor:
    """``a @ b`` over operands rounded to ``dtype``, accumulated and returned
    in float32 (JAX's ``preferred_element_type=float32``)."""
    return torch.matmul(a.to(dtype).float(), b.to(dtype).float())


class TorchLinear(nn.Linear):
    """``nn.Linear`` that computes in ``dtype`` (parameters stay float32)."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features, bias=bias)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), b)


def dropout(x: torch.Tensor, rate: float,
            generator: Optional[torch.Generator]) -> torch.Tensor:
    """flax ``nn.Dropout``: each element kept with probability 1 - rate and
    scaled by 1 / (1 - rate), else 0; the identity without a generator or
    at rate 0. The draw comes from ``generator`` (on x's device)."""
    if generator is None or rate == 0.0:
        return x
    keep = torch.rand(x.shape, generator=generator, device=x.device) >= rate
    return torch.where(keep, x / (1.0 - rate), 0.0)


def causal_mask(length: int, dtype: torch.dtype = torch.float32,
                device=None) -> torch.Tensor:
    """[L, L] additive mask: 0 on and below the diagonal, -inf above."""
    allowed = torch.ones(length, length, dtype=torch.bool, device=device).tril()
    return torch.where(allowed, 0.0, float("-inf")).to(dtype)


def block_causal_mask(blocks: int, length: int,
                      dtype: torch.dtype = torch.float32,
                      device=None) -> torch.Tensor:
    """[blocks*length]^2 additive mask: causal within each diagonal block,
    -inf across blocks (``blocks`` causal sequences packed into one)."""
    allowed = torch.block_diag(*[torch.ones(
        length, length, dtype=torch.bool, device=device).tril()] * blocks)
    return torch.where(allowed, 0.0, float("-inf")).to(dtype)


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(epsilon=1e-5, dtype=dtype)`` semantics: plain
    tensor code on the CPU, the hand-written kernels on the card
    (``ops/row_layer_norm.py``)."""

    def __init__(self, d: int, eps: float = 1e-5,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.eps, self.compute_dtype = eps, dtype
        self.weight = nn.Parameter(torch.ones(d))
        self.bias = nn.Parameter(torch.zeros(d))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return layer_norm(x, self.weight, self.bias, self.eps,
                          self.compute_dtype)


class MultiheadAttention(nn.Module):
    """Torch-layout MHA (packed ``in_proj_weight`` [3D, D]) with the
    incremental pieces the greedy decode uses."""

    def __init__(self, embed_dim: int, num_heads: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % num_heads {num_heads}")
        self.embed_dim, self.num_heads, self.dropout = (
            embed_dim, num_heads, dropout)
        self.head_dim = embed_dim // num_heads
        self.compute_dtype = dtype
        self.in_proj_weight = nn.Parameter(torch.empty(3 * embed_dim, embed_dim))
        self.in_proj_bias = nn.Parameter(torch.zeros(3 * embed_dim))
        self.out_proj = TorchLinear(embed_dim, embed_dim, dtype=dtype)

    def _proj(self, x: torch.Tensor, i: int) -> torch.Tensor:
        d, dt = self.embed_dim, self.compute_dtype
        w = self.in_proj_weight[i * d:(i + 1) * d].to(dt)
        b = self.in_proj_bias[i * d:(i + 1) * d].to(dt)
        return F.linear(x.to(dt), w, b)

    def _split(self, x: torch.Tensor) -> torch.Tensor:   # [B,L,D]->[B,h,L,hd]
        b, l, _ = x.shape
        return x.reshape(b, l, self.num_heads, self.head_dim).transpose(1, 2)

    def _attend(self, q, k, v, mask=None, generator=None) -> torch.Tensor:
        scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) \
            / math.sqrt(self.head_dim)
        if mask is not None:
            scores = scores + mask
        weights = dropout(torch.softmax(scores, dim=-1), self.dropout,
                          generator)
        out = torch.matmul(weights.to(v.dtype).float(), v.float())
        return out.to(self.compute_dtype)

    def forward(self, query, key, value,
                attn_mask: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        q = self._split(self._proj(query, 0))
        k = self._split(self._proj(key, 1))
        v = self._split(self._proj(value, 2))
        out = self._attend(q, k, v, attn_mask, generator)  # [B, h, Lq, hd]
        b, _, lq, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, lq, self.embed_dim))

    def project_kv(self, key, value) -> KV:
        """Head-split K/V [B, h, L, hd] of a fixed memory."""
        return self._split(self._proj(key, 1)), self._split(self._proj(value, 2))

    def project_kv_step(self, x_t) -> KV:
        """K/V [B, h, hd] of one new position."""
        shape = (x_t.shape[0], self.num_heads, self.head_dim)
        return (self._proj(x_t, 1).reshape(shape),
                self._proj(x_t, 2).reshape(shape))

    def attend_step(self, q_t, k, v, group: int = 1) -> torch.Tensor:
        """One query row per batch row ([B*g, D]) against K/V [B, h, Lk, hd];
        ``group=g`` attends g consecutive query rows to each K/V row."""
        bg = q_t.shape[0]
        q = self._proj(q_t, 0).reshape(bg // group, group, self.num_heads,
                                       self.head_dim).transpose(1, 2)
        out = self._attend(q, k, v)                       # [B, h, g, hd]
        return self.out_proj(out.transpose(1, 2).reshape(bg, self.embed_dim))


class _FeedForward(nn.Module):
    def __init__(self, d_model, ffn_dim, dtype, dropout):
        super().__init__()
        self.dropout = dropout
        self.linear1 = TorchLinear(d_model, ffn_dim, dtype=dtype)
        self.linear2 = TorchLinear(ffn_dim, d_model, dtype=dtype)

    def ffn(self, x, generator=None):
        h = dropout(torch.relu(self.linear1(x)), self.dropout, generator)
        return self.linear2(h)

    def drop(self, x, generator):
        return dropout(x, self.dropout, generator)


class EncoderLayer(_FeedForward):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__(d_model, ffn_dim, dtype, dropout)
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype,
                                            dropout)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)

    def forward(self, src, generator=None):
        attn = self.self_attn(src, src, src, generator=generator)
        src = self.norm1(src + self.drop(attn, generator))
        return self.norm2(src + self.drop(self.ffn(src, generator), generator))


class DecoderLayer(_FeedForward):
    def __init__(self, d_model: int, num_heads: int, ffn_dim: int,
                 dtype: torch.dtype = torch.float32, dropout: float = 0.0):
        super().__init__(d_model, ffn_dim, dtype, dropout)
        self.self_attn = MultiheadAttention(d_model, num_heads, dtype,
                                            dropout)
        self.multihead_attn = MultiheadAttention(d_model, num_heads, dtype,
                                                 dropout)
        self.norm1 = LayerNorm(d_model, dtype=dtype)
        self.norm2 = LayerNorm(d_model, dtype=dtype)
        self.norm3 = LayerNorm(d_model, dtype=dtype)

    def forward(self, tgt, memory, tgt_mask=None, generator=None):
        attn = self.self_attn(tgt, tgt, tgt, attn_mask=tgt_mask,
                              generator=generator)
        tgt = self.norm1(tgt + self.drop(attn, generator))
        cross = self.multihead_attn(tgt, memory, memory, generator=generator)
        tgt = self.norm2(tgt + self.drop(cross, generator))
        return self.norm3(tgt + self.drop(self.ffn(tgt, generator),
                                          generator))

    def decode_step(self, x_t, self_kv: KV, cross_kv: KV, t: int,
                    memory_group: int = 1):
        """One greedy-decode position ``t``: writes entry ``t`` of the cache
        buffers [B, h, T, hd] in place and attends to entries 0..t (the
        entries after t are what the JAX package masks with -inf, so leaving
        them out is exact). Returns (y_t [B, D], cache)."""
        k_buf, v_buf = self_kv
        k_t, v_t = self.self_attn.project_kv_step(x_t)
        k_buf[:, :, t] = k_t
        v_buf[:, :, t] = v_t
        attn = self.self_attn.attend_step(
            x_t, k_buf[:, :, :t + 1], v_buf[:, :, :t + 1])
        x = self.norm1(x_t + attn)
        x = self.norm2(x + self.multihead_attn.attend_step(
            x, *cross_kv, group=memory_group))
        return self.norm3(x + self.ffn(x)), (k_buf, v_buf)


class TransformerEncoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 ffn_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.layers = nn.ModuleList(
            EncoderLayer(d_model, num_heads, ffn_dim, dtype, dropout)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, dtype=dtype)

    def forward(self, src, generator=None):
        for layer in self.layers:
            src = layer(src, generator)
        return self.norm(src)


class TransformerDecoder(nn.Module):
    def __init__(self, num_layers: int, d_model: int, num_heads: int,
                 ffn_dim: int, dtype: torch.dtype = torch.float32,
                 dropout: float = 0.0):
        super().__init__()
        self.num_heads, self.d_model, self.compute_dtype = (
            num_heads, d_model, dtype)
        self.layers = nn.ModuleList(
            DecoderLayer(d_model, num_heads, ffn_dim, dtype, dropout)
            for _ in range(num_layers))
        self.norm = LayerNorm(d_model, dtype=dtype)

    def forward(self, tgt, memory, tgt_mask=None, generator=None):
        for layer in self.layers:
            tgt = layer(tgt, memory, tgt_mask=tgt_mask, generator=generator)
        return self.norm(tgt)

    def init_cache(self, batch: int, max_len: int, device=None) -> List[KV]:
        """Zeroed per-layer self-attention K/V buffers [B, h, T, hd]."""
        shape = (batch, self.num_heads, max_len,
                 self.d_model // self.num_heads)
        return [(torch.zeros(shape, dtype=self.compute_dtype, device=device),
                 torch.zeros(shape, dtype=self.compute_dtype, device=device))
                for _ in self.layers]

    def precompute_cross_kv(self, memory) -> List[KV]:
        """Per-layer head-split memory K/V, once per decode."""
        return [layer.multihead_attn.project_kv(memory, memory)
                for layer in self.layers]

    def decode_step(self, x_t, cache: List[KV], cross_kvs: List[KV], t: int,
                    memory_group: int = 1):
        """Run position ``t`` through all layers -> (normed [B, D], cache)."""
        new_cache = []
        for layer, self_kv, cross_kv in zip(self.layers, cache, cross_kvs):
            x_t, self_kv = layer.decode_step(x_t, self_kv, cross_kv, t,
                                             memory_group=memory_group)
            new_cache.append(self_kv)
        return self.norm(x_t), new_cache


class PositionalEncoding(nn.Module):
    """Sinusoidal positions, then dropout; the table is a non-persistent
    buffer."""

    def __init__(self, d_model: int, max_len: int = 5000,
                 dropout: float = 0.0):
        super().__init__()
        self.dropout = dropout
        position = torch.arange(max_len, dtype=torch.float32)[:, None]
        div_term = torch.exp(torch.arange(0, d_model, 2, dtype=torch.float32)
                             * (-math.log(10000.0) / d_model))
        pe = torch.zeros(max_len, d_model)
        pe[:, 0::2] = torch.sin(position * div_term)
        pe[:, 1::2] = torch.cos(position * div_term)
        self.register_buffer("pe", pe, persistent=False)

    def forward(self, x, generator=None):
        return dropout(x + self.pe[None, :x.shape[1]].to(x.dtype),
                       self.dropout, generator)
