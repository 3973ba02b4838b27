"""JAX-package variables -> the port's ``state_dict``.

``from_jax_variables`` is the inverse of the JAX package's
``models/torch_convert.py:convert_pipeline`` for every engine kind: it takes
the ``{"params", "batch_stats"}`` trees of ``graphvqa_tpu.models.
PipelineModel`` as nested dicts of numpy arrays and returns reference-named
torch tensors, which ``PipelineModel.load_state_dict`` takes as they are.
Conventions undone: flax ``kernel`` [in, out] -> torch ``weight`` [out, in];
q/k/v projections -> one packed ``in_proj_weight`` [3D, D]; ``scale`` ->
``weight``; BatchNorm ``mean``/``var`` -> ``running_mean``/``running_var``;
GAT ``lin_lr`` -> ``lin_l.weight`` and ``att_*`` [H, C] -> [1, H, C]; GCN
kernels stay [in, out] (PyG 1.x's ``convs.i.weight``); GINE gets its zero
``eps`` buffer; LCGN's modules take the reference's ``lcgn_seq`` names; the
execution engine (no reference names) keeps the JAX tree's. Numpy only, no
jax.
"""
from __future__ import annotations

from typing import Dict, Mapping

import numpy as np
import torch

StateDict = Dict[str, torch.Tensor]


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32, copy=True))


def _linear(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(np.asarray(p["kernel"]).T)
    if "bias" in p:
        sd[f"{prefix}.bias"] = _t(p["bias"])


def _layernorm(sd: StateDict, prefix: str, p: Mapping) -> None:
    sd[f"{prefix}.weight"] = _t(p["scale"])
    sd[f"{prefix}.bias"] = _t(p["bias"])


def _mha(sd: StateDict, prefix: str, p: Mapping) -> None:
    names = ("q_proj", "k_proj", "v_proj")
    sd[f"{prefix}.in_proj_weight"] = _t(np.concatenate(
        [np.asarray(p[n]["kernel"]).T for n in names], axis=0))
    sd[f"{prefix}.in_proj_bias"] = _t(np.concatenate(
        [np.asarray(p[n]["bias"]) for n in names]))
    _linear(sd, f"{prefix}.out_proj", p["out_proj"])


def _stack(sd: StateDict, prefix: str, p: Mapping, decoder: bool) -> None:
    i = 0
    while f"layer_{i}" in p:
        lp, src = f"{prefix}.layers.{i}", p[f"layer_{i}"]
        _mha(sd, f"{lp}.self_attn", src["self_attn"])
        if decoder:
            _mha(sd, f"{lp}.multihead_attn", src["cross_attn"])
        for n in ("linear1", "linear2"):
            _linear(sd, f"{lp}.{n}", src[n])
        for n in ("norm1", "norm2", "norm3") if decoder else ("norm1", "norm2"):
            _layernorm(sd, f"{lp}.{n}", src[n])
        i += 1
    _layernorm(sd, f"{prefix}.norm", p["final_norm"])


def _seq2(sd: StateDict, prefix: str, p: Mapping) -> None:
    _linear(sd, f"{prefix}.0", p["lin1"])
    _linear(sd, f"{prefix}.2", p["lin2"])


def _bns(sd: StateDict, prefix: str, eng: Mapping, eng_stats: Mapping):
    j = 0
    while f"bn_{j}" in eng:
        bp = f"{prefix}.bns.{j}"
        _layernorm(sd, bp, eng[f"bn_{j}"])
        sd[f"{bp}.running_mean"] = _t(eng_stats[f"bn_{j}"]["mean"])
        sd[f"{bp}.running_var"] = _t(eng_stats[f"bn_{j}"]["var"])
        sd[f"{bp}.num_batches_tracked"] = torch.zeros((), dtype=torch.long)
        j += 1


def _gat_engine(sd: StateDict, eng: Mapping) -> None:
    i = 0
    while f"conv_{i}" in eng:
        cp, conv = f"gat_seq.convs.{i}", eng[f"conv_{i}"]
        sd[f"{cp}.lin_l.weight"] = _t(np.asarray(conv["lin_lr"]).T)
        sd[f"{cp}.lin_e.weight"] = _t(np.asarray(conv["lin_e"]).T)
        for a in ("att_l", "att_r", "att_e"):
            sd[f"{cp}.{a}"] = _t(np.asarray(conv[a])[None])
        sd[f"{cp}.bias"] = _t(conv["bias"])
        i += 1


def _gcn_engine(sd: StateDict, eng: Mapping) -> None:
    i = 0
    while f"conv_{i}_weight" in eng:
        sd[f"gcn_seq.convs.{i}.weight"] = _t(eng[f"conv_{i}_weight"]["kernel"])
        sd[f"gcn_seq.convs.{i}.bias"] = _t(eng[f"conv_{i}_bias"])
        i += 1


def _gine_engine(sd: StateDict, eng: Mapping) -> None:
    i = 0
    while f"conv_{i}_mlp" in eng:
        cp = f"gine_seq.convs.{i}"
        _seq2(sd, f"{cp}.nn", eng[f"conv_{i}_mlp"])
        sd[f"{cp}.eps"] = torch.zeros(1)
        i += 1


def _lcgn_engine(sd: StateDict, eng: Mapping) -> None:
    names = {"init_sg_emb": "init_sg_emb_input.0", "q_input1": "qInput1",
             "cmd_inter2logits": "cmd_inter2logits",
             "proj_x_loc": "proj_x_loc.1", "proj_x_ctx": "proj_x_ctx.1",
             "output_layer": "output_layer", "fin_layer": "fin_layer"}
    t = 0
    while f"q_input2_{t}" in eng:
        names[f"q_input2_{t}"] = f"qInput2_{t}"
        t += 1
    for jax_name, ref_name in names.items():
        _linear(sd, f"lcgn_seq.{ref_name}", eng[jax_name])
    cell = eng["cell"]
    for n in ("lin_l", "lin_r", "cal_x", "proj_cmd", "cal_cmd"):
        sd[f"lcgn_seq.lcgn.{n}.weight"] = _t(np.asarray(cell[n]["kernel"]).T)
    sd["lcgn_seq.lcgn.bias"] = _t(cell["bias"])


_ENGINES = {"gat": ("gat_seq", _gat_engine), "none": ("gat_seq", _gat_engine),
            "gcn": ("gcn_seq", _gcn_engine),
            "gine": ("gine_seq", _gine_engine),
            "lcgn": ("lcgn_seq", _lcgn_engine)}


def from_jax_engine(kind: str, params: Mapping,
                    batch_stats: Mapping) -> StateDict:
    """The JAX engine's params and batch_stats of ``kind`` (gat, none, gcn,
    gine or lcgn) -> the port's ``state_dict`` entries, named under the
    pipeline's ``gat_seq`` / ``gcn_seq`` / ``gine_seq`` / ``lcgn_seq``."""
    if kind not in _ENGINES:
        raise ValueError(f"unknown engine kind: {kind}")
    prefix, engine = _ENGINES[kind]
    sd: StateDict = {}
    engine(sd, params)
    _bns(sd, prefix, params, batch_stats)
    return sd


def from_jax_execution_engine(params: Mapping) -> StateDict:
    """The JAX ``RecurrentExecutionEngine``'s params -> the port's entries
    under ``execution_engine``."""
    sd: StateDict = {}
    for n in ("node_mlp_1", "node_mlp_2", "bitmap_gate_mlp", "history_mlp"):
        _seq2(sd, f"execution_engine.{n}", params[n])
    for n in ("ln_weight", "ln_bias"):
        sd[f"execution_engine.{n}"] = _t(np.reshape(params[n], (1,)))
    return sd


def from_jax_variables(variables: Mapping, kind: str = "gat") -> StateDict:
    """``{"params": ..., "batch_stats": ...}`` of the JAX pipeline whose
    engine is ``kind`` (``EngineConfig.kind``: gat, none, gcn, gine or
    lcgn) -> the port's ``state_dict`` (float32 tensors)."""
    p, stats = variables["params"], variables.get("batch_stats", {})
    sd: StateDict = {}
    sd["text_vocab_embedding.weight"] = _t(
        p["text_vocab_embedding"]["embedding"])

    sge = p["scene_graph_encoder"]
    sd["scene_graph_encoder.sg_vocab_embedding.weight"] = _t(
        sge["sg_vocab_embedding"]["embedding"])
    base = "scene_graph_encoder.scene_graph_encoding_layer"
    meta = sge["meta_layer"]
    _seq2(sd, f"{base}.edge_model.edge_mlp", meta["edge_mlp"])
    _seq2(sd, f"{base}.node_model.node_mlp_1", meta["node_mlp_1"])
    _seq2(sd, f"{base}.node_model.node_mlp_2", meta["node_mlp_2"])
    sd["scene_graph_encoder.graph_layer_norm.weight"] = _t(
        np.reshape(sge["ln_weight"], (1,)))
    sd["scene_graph_encoder.graph_layer_norm.bias"] = _t(
        np.reshape(sge["ln_bias"], (1,)))

    qe = p["question_encoder"]
    _linear(sd, "question_encoder.emb_proj", qe["emb_proj"])
    _stack(sd, "question_encoder.transformer_encoder", qe["encoder"], False)

    pd = p["program_decoder"]
    sd["program_decoder.query_embed.weight"] = _t(pd["query_embed"])
    _linear(sd, "program_decoder.emb_proj", pd["emb_proj"])
    _stack(sd, "program_decoder.coarse_decoder", pd["coarse_decoder"], True)
    _stack(sd, "program_decoder.transformer_decoder", pd["fine_decoder"], True)
    _linear(sd, "program_decoder.vocab_decoder", pd["vocab_decoder"])

    if "full_answer_decoder" in p:
        fa = p["full_answer_decoder"]
        _linear(sd, "full_answer_decoder.emb_proj", fa["emb_proj"])
        _stack(sd, "full_answer_decoder.transformer_decoder", fa["decoder"],
               True)
        _linear(sd, "full_answer_decoder.vocab_decoder", fa["vocab_decoder"])

    sd.update(from_jax_engine(kind, p["engine"], stats.get("engine", {})))
    if "execution_engine" in p:
        sd.update(from_jax_execution_engine(p["execution_engine"]))

    pool = p["pooling"]
    for n in ("gate_nn", "node_nn", "ques_nn"):
        _seq2(sd, f"graph_global_attention_pooling.{n}", pool[n])
    _linear(sd, "logit_fc.1", p["logit_fc_hidden"])
    _linear(sd, "logit_fc.4", p["logit_fc_out"])
    return sd
