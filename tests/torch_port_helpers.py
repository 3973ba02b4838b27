"""Shared fixtures of the port's parity tests: seeded tiny-model weights
(with randomized BatchNorm statistics) for both packages, and JAX batches
turned into the port's containers, numpy in between."""
import dataclasses

import jax
import numpy as np
import torch

import graphvqa_tpu_torch.config as pcfg
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.models.torch_convert import convert_pipeline
from graphvqa_tpu_torch.core.graph import GraphBatch, QABatch
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.models.pipeline import PipelineModel, init_params
from tests.helpers import random_qa_batch, tiny_model_config

_SUB = {"text": pcfg.TextConfig, "scene": pcfg.SceneGraphConfig,
        "transformer": pcfg.TransformerConfig, "engine": pcfg.EngineConfig}


def port_model_config(jax_cfg) -> pcfg.ModelConfig:
    """The JAX package's ModelConfig as the port's (same field names)."""
    fields = dataclasses.asdict(jax_cfg)
    for name, cls in _SUB.items():
        fields[name] = cls(**fields[name])
    return pcfg.ModelConfig(**fields)


# the JAX converter's name of each engine kind ("none" is the onlysg model)
CONVERTER_KIND = {"gat": "gat", "none": "onlysg", "gcn": "gcn",
                  "gine": "gine", "lcgn": "lcgn"}


def execution_engine_params(sd):
    """The port's ``execution_engine.*`` entries as the JAX engine's params
    (the reference has no names for this engine, so the JAX converter has
    no mapping)."""
    def linear(prefix):
        return {"kernel": sd[f"{prefix}.weight"].T.copy(),
                "bias": sd[f"{prefix}.bias"]}

    base = "execution_engine"
    p = {n: {"lin1": linear(f"{base}.{n}.0"), "lin2": linear(f"{base}.{n}.2")}
         for n in ("node_mlp_1", "node_mlp_2", "bitmap_gate_mlp",
                   "history_mlp")}
    p["ln_weight"] = sd[f"{base}.ln_weight"]
    p["ln_bias"] = sd[f"{base}.ln_bias"]
    return p


def jax_variables(cfg, seed=0):
    """JAX-package variables (numpy leaves) for the tiny model of
    ``cfg.engine.kind``: seeded random weights with randomized BatchNorm
    running statistics, mapped into the JAX tree by the JAX package's own
    reference-checkpoint converter (``convert_pipeline(sd, kind=...)``;
    the execution engine by :func:`execution_engine_params`)."""
    model = PipelineModel(port_model_config(cfg))
    init_params(model, torch.Generator().manual_seed(seed))
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    rng = np.random.default_rng(seed + 100)
    for k in sd:
        if k.endswith("running_mean"):
            sd[k] = rng.normal(size=sd[k].shape).astype(np.float32) * 0.5
        elif k.endswith("running_var"):
            sd[k] = rng.uniform(0.5, 2.0, sd[k].shape).astype(np.float32)
    L = cfg.transformer.num_layers
    variables = convert_pipeline(
        sd, kind=CONVERTER_KIND[cfg.engine.kind], num_encoder_layers=L,
        num_decoder_layers=L, num_rounds=cfg.engine.num_rounds,
        lcgn_iters=cfg.engine.lcgn_iters)
    if cfg.use_execution_engine:
        variables["params"]["execution_engine"] = execution_engine_params(sd)
    return variables


def jax_init_shapes(cfg):
    """Shapes of ``PipelineModel.init``'s variables, traced, not run."""
    batch = random_qa_batch(cfg=cfg, dense=True)
    model_in = batch.replace(programs=batch.programs[:, :-1],
                             full_answers=batch.full_answers[:, :-1])
    rngs = {"params": jax.random.key(0), "dropout": jax.random.key(1),
            "lcgn_ctx": jax.random.key(2)}
    shapes = jax.eval_shape(JaxPipelineModel(cfg).init, rngs, model_in)
    return jax.tree.map(lambda a: a.shape, shapes)


def port_model(cfg, variables) -> PipelineModel:
    model = PipelineModel(port_model_config(cfg))
    model.load_state_dict(from_jax_variables(variables, cfg.engine.kind))
    return model.eval()


def port_graph(g) -> GraphBatch:
    t = {f.name: torch.from_numpy(np.array(getattr(g, f.name)))
         for f in dataclasses.fields(GraphBatch)
         if f.name not in ("num_graphs", "nodes_per_graph", "edges_per_graph")}
    return GraphBatch(**t, num_graphs=g.num_graphs,
                      nodes_per_graph=g.nodes_per_graph,
                      edges_per_graph=g.edges_per_graph)


def port_batch(b) -> QABatch:
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    return QABatch(graphs=port_graph(b.graphs), questions=t(b.questions),
                   programs=t(b.programs), full_answers=t(b.full_answers),
                   short_answer_label=t(b.short_answer_label))


__all__ = ["CONVERTER_KIND", "execution_engine_params", "port_model_config",
           "jax_variables", "jax_init_shapes",
           "port_model", "port_graph", "port_batch", "random_qa_batch",
           "tiny_model_config"]
