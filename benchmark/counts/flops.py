"""Operations of GraphVQA's matrix products on one batch, from the
configuration's widths and the batch's real counts (the benchmark's own
count, for the share of the chip's peak).

A product of an [m, k] by a [k, n] matrix counts 2 m k n. Counted: every
linear layer, the attention score and value products (the causal ones over
the positions a query may see) and the engine's products (``flops`` of its
file, ``engines/<kind>.py``), on each question's real nodes and edges and
on its real tokens: the question's non-padding tokens, each program stream's
non-padding teacher-forced inputs in training, and every decoded position
in greedy decoding. Not counted: padding rows, embeddings (gathers),
softmaxes, norms and other elementwise work. Training counts the forward
three times (the backward as twice the forward); nothing recomputed counts.
"""
from __future__ import annotations

import numpy as np

import engines


def _lin(rows, k, n):
    return 2.0 * rows * k * n


def _attn(q_rows, k_rows, d):
    """QK^T and the weighted sum of values."""
    return 4.0 * q_rows * k_rows * d


def _decoder(cfg, positions, causal_pairs, mem_rows, vocab):
    """A decoder stack over ``positions`` rows per stream with
    ``causal_pairs`` (query, key) pairs, cross-attending ``mem_rows``
    memory rows (their K/V once per question), then the vocabulary."""
    t = cfg["transformer"]
    D, Fd, L = t["hidden_dim"], t["ffn_dim"], t["num_layers"]
    per_layer = (_lin(positions, D, 3 * D) + 4.0 * causal_pairs * D
                 + _lin(positions, D, D)                      # self
                 + _lin(positions, D, D) + _lin(mem_rows, D, 2 * D)
                 + _attn(positions, mem_rows, D) + _lin(positions, D, D)
                 + _lin(positions, D, Fd) + _lin(positions, Fd, D))
    return L * per_layer + _lin(positions, D, vocab)


def forward_flops(cfg: dict, q_tokens, prog_positions, nodes, edges,
                  greedy: bool) -> float:
    """Forward operations of a batch. ``q_tokens`` [B] real question tokens;
    ``prog_positions`` [B, M] positions decoded per program stream; ``nodes``
    / ``edges`` [B] real counts. ``greedy`` adds the full-answer decoder's
    positions (the eval path)."""
    q = np.asarray(q_tokens, np.float64)
    pp = np.asarray(prog_positions, np.float64)
    n = np.asarray(nodes, np.float64)
    e = np.asarray(edges, np.float64)
    t = cfg["transformer"]
    D, Fd, L = t["hidden_dim"], t["ffn_dim"], t["num_layers"]
    E_t, C = cfg["text"]["emb_dim"], cfg["scene"]["emb_dim"]
    V, A, M = cfg["text"]["vocab_size"], cfg["num_answers"], \
        cfg["max_execution_steps"]
    total = 0.0
    # question encoder
    total += (_lin(q, E_t, D) + L * (_lin(q, D, 3 * D) + _attn(q, q, D)
                                     + _lin(q, D, D) + _lin(q, D, Fd)
                                     + _lin(q, Fd, D))).sum()
    # coarse stage: M queries
    total += (L * (_lin(M, D, 3 * D) + _attn(M, M, D) + _lin(M, D, D)
                   + _lin(M, D, D) + _lin(q, D, 2 * D) + _attn(M, q, D)
                   + _lin(M, D, D) + _lin(M, D, Fd) + _lin(M, Fd, D))).sum()
    # fine stage: each stream's positions, causal, memory K/V per question
    pairs = (pp * (pp + 1) / 2).sum(1)
    rows = pp.sum(1)
    total += (_lin(rows, E_t, D) + _decoder(cfg, rows, pairs, q, V)).sum()
    if greedy and cfg["use_full_answer"]:
        T = cfg["full_answer_decode_len"] - 1
        total += (_lin(T, E_t, D)
                  + _decoder(cfg, T, T * (T + 1) / 2, q, V)).sum()
    # scene-graph encoder
    total += (_lin(e, 3 * C, C) + _lin(e, C, C) + _lin(e, 2 * C, C)
              + _lin(e, C, C) + _lin(n, 2 * C, C) + _lin(n, C, C)).sum()
    # engine
    ops, node_dim = engines.load(cfg["engine"]["kind"]).flops(cfg, n, e, q)
    total += ops
    # pooling and classifier
    total += (_lin(n, node_dim, D) + _lin(n, D, D) + 2 * _lin(1, D, D)
              + _lin(n, D, D) + _lin(n, D, 1)
              + _lin(1, 3 * D, cfg["classifier_hidden"])
              + _lin(1, cfg["classifier_hidden"], A)).sum()
    return float(total)


def batch_flops(cfg: dict, counts: dict, train: bool) -> float:
    """Operations of one step on a batch whose real counts are ``counts``
    (``q_tokens``, ``prog_positions``, ``nodes``, ``edges``): the forward,
    three times over in training."""
    fwd = forward_flops(cfg, counts["q_tokens"], counts["prog_positions"],
                        counts["nodes"], counts["edges"], greedy=not train)
    return 3.0 * fwd if train else fwd
