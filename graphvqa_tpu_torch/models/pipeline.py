"""The pipeline model of every family (port of
``graphvqa_tpu/models/pipeline.py``): ``forward`` is the teacher-forced
training path (``sample=False``), ``sample`` the greedy-eval path.

  scene-graph encoder -> question encoder -> program decoder (instruction
  vectors + program logits or greedy tokens) -> [execution engine] ->
  engine (gat | gcn | gine | lcgn; "none" is the onlysg ablation: the GAT
  engine with the question memory zeroed) -> conditional pooling ->
  short-answer classifier (+ full-answer logits or tokens)

Parameter names are the reference checkpoint's (``text_vocab_embedding``,
``scene_graph_encoder``, ``question_encoder``, ``program_decoder``,
``full_answer_decoder``, ``gat_seq`` / ``gcn_seq`` / ``gine_seq`` /
``lcgn_seq``, ``graph_global_attention_pooling``, ``logit_fc.{1,4}``; the
execution engine, absent from the released models, takes the JAX tree's
names), so ``load_state_dict`` takes a reference checkpoint and
``models/convert.py`` maps the JAX package's variables onto it.

LCGN draws its initial context features at every forward (training and
evaluation) from ``ctx_generator``, a ``torch.Generator`` that the caller
passes; an lcgn model given none raises.

With the program's tracing on (``core/profiling.py``) both paths begin a
step's device segments and stamp the end of each stage: ``encoders``
(scene graph and question), ``program_decoder``, ``engine`` (the execution
engine with the GAT/GCN/GINE/LCGN engine), ``classifier`` (pooling and
head) and ``full_answer_decoder``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
from torch import nn

from graphvqa_tpu_torch.config import ModelConfig
from graphvqa_tpu_torch.core import profiling
from graphvqa_tpu_torch.core.device import DeviceLike, resolve_device
from graphvqa_tpu_torch.core.graph import QABatch
from graphvqa_tpu_torch.nn.decoders import FullAnswerDecoder, ProgramDecoder
from graphvqa_tpu_torch.nn.embedding import PaddedEmbed
from graphvqa_tpu_torch.nn.encoders import QuestionEncoder, SceneGraphEncoder
from graphvqa_tpu_torch.nn.execution import RecurrentExecutionEngine
from graphvqa_tpu_torch.nn.gnn import (
    GATLayer, GATSeq, GCNConv, GCNSeq, GINESeq, LCGNCell, LCGNSeq)
from graphvqa_tpu_torch.nn.pooling import ConditionalGlobalAttention
from graphvqa_tpu_torch.nn.transformer import TorchLinear, dropout


@dataclasses.dataclass
class ModelOutput:
    short_answer_logits: torch.Tensor                 # [B, num_answers]
    instr_vectors: torch.Tensor                       # [M, B, D]
    program_logits: Optional[torch.Tensor] = None     # [B*M, Lp, V]
    program_tokens: Optional[torch.Tensor] = None     # [B*M, T]
    full_answer_logits: Optional[torch.Tensor] = None  # [B, La, V]
    full_answer_tokens: Optional[torch.Tensor] = None  # [B, T]
    execution_bitmap: Optional[torch.Tensor] = None   # [N, M]
    node_attention: Optional[torch.Tensor] = None     # [N] pooling gate
    edge_attention: Optional[torch.Tensor] = None     # [rounds, E, H]


class PipelineModel(nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.cfg = cfg
        dt = getattr(torch, cfg.dtype)
        t, e = cfg.transformer, cfg.engine
        Et, Es, D = cfg.text.emb_dim, cfg.scene.emb_dim, t.hidden_dim
        self.text_vocab_embedding = PaddedEmbed(
            cfg.text.vocab_size, Et, cfg.text.pad_idx)
        self.scene_graph_encoder = SceneGraphEncoder(
            cfg.scene.vocab_size, Es, cfg.scene.pad_idx, dt)
        self.question_encoder = QuestionEncoder(
            Et, D, t.num_heads, t.ffn_dim, t.num_layers, dt, t.dropout)
        self.program_decoder = ProgramDecoder(
            Et, cfg.text.vocab_size, cfg.max_execution_steps, D, t.num_heads,
            t.ffn_dim, t.num_layers, cfg.text.sos_idx, cfg.text.pad_idx,
            cfg.program_decode_len, dt, t.dropout)
        if cfg.use_full_answer:
            # the JAX model fixes this decoder's dropout at 0.1, whatever
            # transformer.dropout says
            self.full_answer_decoder = FullAnswerDecoder(
                Et, cfg.text.vocab_size, D, t.num_heads, t.ffn_dim,
                t.num_layers, cfg.text.sos_idx, cfg.text.pad_idx,
                cfg.full_answer_decode_len, dt, dropout=0.1)
        if e.kind in ("gat", "none"):
            self.gat_seq = GATSeq(Es, D, e.num_rounds, e.heads,
                                  e.negative_slope, dt, e.dropout)
        elif e.kind == "gcn":
            self.gcn_seq = GCNSeq(Es, D, e.num_rounds, dt, e.dropout)
        elif e.kind == "gine":
            self.gine_seq = GINESeq(Es, D, e.num_rounds, dt, e.dropout)
        elif e.kind == "lcgn":
            # LCGN's out width is the transformer's, so the pooling reads
            # D-wide nodes
            self.lcgn_seq = LCGNSeq(Es, D, D, e.lcgn_iters, e.lcgn_heads,
                                    e.negative_slope, e.dropout)
        else:
            raise ValueError(f"unknown engine kind: {e.kind}")
        self.graph_global_attention_pooling = ConditionalGlobalAttention(
            D if e.kind == "lcgn" else Es, D, dt)
        if cfg.use_execution_engine:
            self.execution_engine = RecurrentExecutionEngine(
                Es, D, cfg.max_execution_steps, dt)
        # Sequential(Dropout, Linear, ELU, Dropout, Linear), reference
        # layout; _classify runs it with explicit dropout draws
        self.logit_fc = nn.Sequential(
            nn.Dropout(cfg.classifier_dropout),
            TorchLinear(3 * D, cfg.classifier_hidden, dtype=dt), nn.ELU(),
            nn.Dropout(cfg.classifier_dropout),
            TorchLinear(cfg.classifier_hidden, cfg.num_answers, dtype=dt))

    def _classify(self, graph, x_exec, memory, generator=None):
        """Pooling and the short-answer classifier -> (logits, gate [N, 1])."""
        q_feat = memory[:, 0, :]          # <start>-position encoding
        graph_feat, gate = self.graph_global_attention_pooling(
            graph, x_exec, q_feat)
        fused = torch.cat([graph_feat, q_feat, graph_feat * q_feat], dim=-1)
        rate = self.cfg.classifier_dropout
        h = self.logit_fc[1](dropout(fused, rate, generator))
        h = dropout(self.logit_fc[2](h), rate, generator)
        return self.logit_fc[4](h), gate

    def forward(self, batch: QABatch, *, deterministic: bool = True,
                use_running_average: bool = True,
                generator: Optional[torch.Generator] = None,
                ctx_generator: Optional[torch.Generator] = None,
                return_edge_attention: bool = False,
                full_answer: bool = True) -> ModelOutput:
        """Teacher-forced forward (``sample=False`` in the JAX package): the
        batch carries the input streams (``programs[:, :-1]``,
        ``full_answers[:, :-1]``). ``deterministic=False`` applies dropout,
        drawn from ``generator`` (a ``torch.Generator`` on the batch's
        device); ``use_running_average=False`` normalizes with batch
        statistics and updates the running ones. ``full_answer=False``
        skips the full-answer decoder (no loss of the shipped configurations
        reads it). ``ctx_generator`` draws LCGN's initial context features.
        ``return_edge_attention`` (GAT engines only) adds the attention of
        every round."""
        gen = None
        if not deterministic:
            if generator is None:
                raise ValueError("deterministic=False needs a generator")
            gen = generator
        graph, emb = batch.graphs, self.text_vocab_embedding
        dev = batch.questions.device
        profiling.begin(dev)
        x_enc, edge_enc = self.scene_graph_encoder(graph)
        memory = self._encode_questions(batch, gen)
        profiling.stamp("encoders", dev)
        program_logits, instr = self.program_decoder(memory, batch.programs,
                                                     emb, gen)
        profiling.stamp("program_decoder", dev)
        bitmap = self._execute(graph, x_enc, instr)
        x_exec, edge_attention = self._engine(
            graph, x_enc, edge_enc, instr, memory, gen, ctx_generator,
            use_running_average, return_edge_attention)
        profiling.stamp("engine", dev)
        logits, gate = self._classify(graph, x_exec, memory, gen)
        profiling.stamp("classifier", dev)
        fa_logits = None
        if self.cfg.use_full_answer and full_answer:
            fa_logits = self.full_answer_decoder(memory, batch.full_answers,
                                                 emb, gen)
            profiling.stamp("full_answer_decoder", dev)
        return ModelOutput(short_answer_logits=logits, instr_vectors=instr,
                           program_logits=program_logits,
                           full_answer_logits=fa_logits,
                           execution_bitmap=bitmap,
                           node_attention=gate[:, 0],
                           edge_attention=edge_attention)

    @torch.no_grad()
    def sample(self, batch: QABatch,
               ctx_generator: Optional[torch.Generator] = None
               ) -> ModelOutput:
        """Greedy-decode forward (the eval path), deterministic but for
        LCGN's draw from ``ctx_generator``."""
        graph, dev = batch.graphs, batch.questions.device
        profiling.begin(dev)
        x_enc, edge_enc = self.scene_graph_encoder(graph)
        memory = self._encode_questions(batch)
        profiling.stamp("encoders", dev)
        program_tokens, instr = self.program_decoder.sample(
            memory, self.text_vocab_embedding)
        profiling.stamp("program_decoder", dev)
        bitmap = self._execute(graph, x_enc, instr)
        x_exec, _ = self._engine(graph, x_enc, edge_enc, instr, memory,
                                 ctx_generator=ctx_generator)
        profiling.stamp("engine", dev)
        logits, gate = self._classify(graph, x_exec, memory)
        profiling.stamp("classifier", dev)
        fa_tokens = None
        if self.cfg.use_full_answer:
            fa_tokens = self.full_answer_decoder.sample(
                memory, self.text_vocab_embedding)
            profiling.stamp("full_answer_decoder", dev)
        return ModelOutput(short_answer_logits=logits, instr_vectors=instr,
                           program_tokens=program_tokens,
                           full_answer_tokens=fa_tokens,
                           execution_bitmap=bitmap,
                           node_attention=gate[:, 0])

    def _encode_questions(self, batch: QABatch, generator=None):
        """The question memory [B, L, D]; zeros for the onlysg ablation
        (engine "none"), which removes all language information downstream
        (its encoder's output would be discarded, so it does not run)."""
        if self.cfg.engine.kind == "none":
            B, L = batch.questions.shape
            return torch.zeros(B, L, self.cfg.transformer.hidden_dim,
                               dtype=getattr(torch, self.cfg.dtype),
                               device=batch.questions.device)
        return self.question_encoder(batch.questions,
                                     self.text_vocab_embedding, generator)

    def _execute(self, graph, x_enc, instr):
        """The execution bitmap [N, M] (None without the engine)."""
        if not self.cfg.use_execution_engine:
            return None
        return self.execution_engine(graph, x_enc, instr)[1]

    def _engine(self, graph, x_enc, edge_enc, instr, memory, generator=None,
                ctx_generator=None, use_running_average=True,
                return_edge_attention=False):
        """The engine of the configured kind -> (node features, the GAT
        attention [rounds, E, H] or None)."""
        kind = self.cfg.engine.kind
        common = dict(generator=generator,
                      use_running_average=use_running_average)
        if kind in ("gat", "none"):
            out = self.gat_seq(graph, x_enc, edge_enc, instr,
                               return_alpha=return_edge_attention, **common)
            return out if return_edge_attention else (out, None)
        if kind == "gcn":
            return self.gcn_seq(graph, x_enc, instr, **common), None
        if kind == "gine":
            return self.gine_seq(graph, x_enc, edge_enc, instr,
                                 **common), None
        return self.lcgn_seq(graph, x_enc, memory[:, 0, :], memory,
                             generator=generator,
                             ctx_generator=ctx_generator), None


def _uniform_(t: torch.Tensor, bound: float, gen: torch.Generator):
    t.uniform_(-bound, bound, generator=gen)


def _glorot_(w: torch.Tensor, fan_in: int, fan_out: int,
             gen: torch.Generator):
    _uniform_(w, math.sqrt(6.0 / (fan_in + fan_out)), gen)


def init_params(model: PipelineModel, generator: torch.Generator) -> None:
    """Deterministic random weights from ``generator`` (a CPU generator gives
    the same weights whatever device the model is later moved to): torch's
    Linear scheme U(+-1/sqrt(fan_in)) for linear layers, N(0, 1) for the
    embeddings, glorot-uniform for the GAT, GCN and LCGN-cell projections
    and the GAT attention vectors (their biases 0), ones and zeros for the
    norms. BatchNorm running stats keep 0 / 1."""
    glorot_lins = set()
    for m in model.modules():
        if isinstance(m, GATLayer):
            glorot_lins.update(id(lin) for lin in (m.lin_l, m.lin_e))
        elif isinstance(m, LCGNCell):
            glorot_lins.update(id(lin) for lin in m.glorot_linears())
    with torch.no_grad():
        for module in model.modules():
            if isinstance(module, GATLayer):
                for lin in (module.lin_l, module.lin_e):
                    fan_out, fan_in = lin.weight.shape
                    _glorot_(lin.weight, fan_in, fan_out, generator)
                for att in (module.att_l, module.att_r, module.att_e):
                    _, H, C = att.shape
                    _glorot_(att, H, C, generator)
                module.bias.zero_()
            elif isinstance(module, LCGNCell):
                for lin in module.glorot_linears():
                    fan_out, fan_in = lin.weight.shape
                    _glorot_(lin.weight, fan_in, fan_out, generator)
                module.bias.zero_()
            elif isinstance(module, GCNConv):
                _glorot_(module.weight, *module.weight.shape, generator)
                module.bias.zero_()
            elif isinstance(module, nn.Linear) and id(module) not in glorot_lins:
                bound = 1.0 / math.sqrt(module.in_features)
                _uniform_(module.weight, bound, generator)
                if module.bias is not None:
                    _uniform_(module.bias, bound, generator)
            elif isinstance(module, (PaddedEmbed, nn.Embedding)):
                module.weight.normal_(0.0, 1.0, generator=generator)
        for name, p in model.named_parameters():
            if name.endswith("in_proj_weight"):
                _uniform_(p, 1.0 / math.sqrt(p.shape[1]), generator)
            elif name.endswith("in_proj_bias"):
                _uniform_(p, 1.0 / math.sqrt(p.shape[0] // 3), generator)


def build_model(cfg: ModelConfig, device: DeviceLike = None, seed: int = 0
                ) -> PipelineModel:
    """PipelineModel with random weights from a seeded CPU generator, in
    eval mode on ``device`` (None means the GPU; raises without one)."""
    dev = resolve_device(device)
    model = PipelineModel(cfg)
    init_params(model, torch.Generator().manual_seed(seed))
    return model.to(dev).eval()
