"""The port's whole eval slice against the JAX package.

The port's ``make_eval_step`` and JAX's ``make_eval_step`` answer the same
``random_qa_batch(dense=True)`` with the same weights (randomized BatchNorm
statistics). float32: short-answer logits within rtol/atol 1e-4 (the same
sums in another order over some 20 layers), ``sa_pred``, program tokens and
the program-match vectors equal, node attention within atol 1e-5. bfloat16:
logits within atol 5e-2 (the two frameworks round at other places).
"""
import dataclasses
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvqa_tpu_torch.config as pcfg
from graphvqa_tpu.config import Config as JaxConfig
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.models.torch_convert import convert_pipeline
from graphvqa_tpu.train.loop import make_eval_step as jax_make_eval_step
from graphvqa_tpu.train.train_state import create_train_state
from graphvqa_tpu_torch.models.pipeline import build_model
from graphvqa_tpu_torch.train.loop import make_eval_step
from tests.torch_port_helpers import (
    jax_init_shapes, jax_variables, port_batch, port_model,
    port_model_config, random_qa_batch, tiny_model_config)

REPO = pathlib.Path(__file__).resolve().parents[1]


def _both(dtype):
    cfg = tiny_model_config(dtype=dtype)
    variables = jax_variables(cfg)
    jb = random_qa_batch(seed=5, num_graphs=4, cfg=cfg, dense=True)
    jvars = jax.tree.map(jnp.asarray, variables)
    jmodel = JaxPipelineModel(cfg)
    want_vec, want_prog, want_att = jax_make_eval_step(
        jmodel, JaxConfig(model=cfg))(
        create_train_state(jvars), jb, jax.random.key(0))
    want_logits = jax.jit(lambda v, b: jmodel.apply(
        v, b.replace(programs=b.programs[:, :-1],
                     full_answers=b.full_answers[:, :-1]),
        sample=True, deterministic=True,
        use_running_average=True).short_answer_logits)(jvars, jb)

    model = port_model(cfg, variables)
    batch = port_batch(jb)
    got_vec, got_prog, got_att = make_eval_step(
        model, pcfg.Config(model=port_model_config(cfg)))(batch)
    got_logits = model.sample(batch).short_answer_logits
    return dict(jb=jb, want=(want_vec, want_prog, want_att, want_logits),
                got=(got_vec, got_prog, got_att, got_logits))


@pytest.fixture(scope="module")
def f32():
    return _both("float32")


def test_eval_step_logits_f32(f32):
    np.testing.assert_allclose(f32["got"][3].numpy(),
                               np.asarray(f32["want"][3]), rtol=1e-4, atol=1e-4)


def test_eval_step_tokens_and_vectors_equal_f32(f32):
    want_vec, want_prog, _, _ = f32["want"]
    got_vec, got_prog, _, _ = f32["got"]
    np.testing.assert_array_equal(got_prog.numpy(), np.asarray(want_prog))
    assert set(got_vec) == set(want_vec)
    for key in ("sa_pred", "program_match", "program_group_match",
                "program_empty"):
        np.testing.assert_array_equal(got_vec[key].numpy(),
                                      np.asarray(want_vec[key]), err_msg=key)
    np.testing.assert_allclose(got_vec["sa_score"].numpy(),
                               np.asarray(want_vec["sa_score"]),
                               rtol=1e-4, atol=1e-4)


def test_eval_step_node_attention_f32(f32):
    real = np.asarray(f32["jb"].graphs.node_mask)
    np.testing.assert_allclose(f32["got"][2].numpy()[real],
                               np.asarray(f32["want"][2])[real], atol=1e-5)


def test_eval_step_logits_bf16():
    both = _both("bfloat16")
    got = both["got"][3].float().numpy()
    want = np.asarray(both["want"][3], np.float32)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=0, atol=5e-2)


def test_weights_round_trip_through_reference_names():
    """port state_dict -> the JAX package's converter == the JAX params,
    and the tree matches what ``PipelineModel.init`` makes."""
    cfg = tiny_model_config()
    variables = jax_variables(cfg, seed=1)
    sd = {k: v.numpy() for k, v in port_model(cfg, variables)
          .state_dict().items()}
    L = cfg.transformer.num_layers
    back = convert_pipeline(sd, kind="gat", num_encoder_layers=L,
                            num_decoder_layers=L,
                            num_rounds=cfg.engine.num_rounds)
    want_leaves, want_def = jax.tree.flatten(variables)
    got_leaves, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    shapes = jax.tree.map(lambda a: tuple(np.shape(a)), variables)
    init = jax_init_shapes(cfg)
    assert shapes == {"params": init["params"],
                      "batch_stats": init["batch_stats"]}


def test_port_config_mirrors_jax_config():
    from graphvqa_tpu.config import gat_config as jax_gat_config
    want = dataclasses.asdict(jax_gat_config())
    got = dataclasses.asdict(pcfg.gat_config())
    assert got["model"] == want["model"]
    assert got["batch"] == want["batch"]
    assert got["train"] == want["train"]


def test_port_runs_without_jax_flax_or_the_jax_package():
    code = """
import re
import sys
for name in ("jax", "jaxlib", "flax", "graphvqa_tpu"):
    sys.modules[name] = None
import numpy as np, torch
import graphvqa_tpu_torch.cli.train_cli
import graphvqa_tpu_torch.data.dataset
import graphvqa_tpu_torch.data.prefetch
import graphvqa_tpu_torch.data.synthetic
import graphvqa_tpu_torch.eval.scorer
import graphvqa_tpu_torch.models.pretrained
import graphvqa_tpu_torch.ops.layernorm
from graphvqa_tpu_torch.config import (
    Config, EngineConfig, ModelConfig, SceneGraphConfig, TextConfig,
    TransformerConfig)
from graphvqa_tpu_torch.core import (
    GraphSample, QABatch, pack_graphs, pack_graphs_dense)
from graphvqa_tpu_torch.core.native import packer_name
from graphvqa_tpu_torch.models.pipeline import build_model
from graphvqa_tpu_torch.train.loop import make_eval_step, make_train_step
from graphvqa_tpu_torch.train.train_state import create_train_state
cfg = ModelConfig(
    text=TextConfig(vocab_size=60, emb_dim=16),
    scene=SceneGraphConfig(vocab_size=40, emb_dim=12),
    transformer=TransformerConfig(hidden_dim=32, num_heads=4, ffn_dim=64,
                                  num_layers=2),
    engine=EngineConfig(num_rounds=3, heads=2), num_answers=20,
    max_execution_steps=3, program_decode_len=8, full_answer_decode_len=8,
    classifier_hidden=32, dtype="float32")
rng = np.random.default_rng(0)
def sample(n, e):
    return GraphSample(
        rng.integers(2, 40, (n, 12)).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32),
        rng.integers(0, n, e).astype(np.int32),
        rng.integers(2, 40, (e, 1)).astype(np.int32), rng.random(e) > 0.7)
g = pack_graphs_dense([sample(5, 9), sample(7, 14)], 8, 16, max_steps=3)
t = lambda a: torch.from_numpy(a.astype(np.int32))
batch = QABatch(g, t(rng.integers(4, 60, (2, 7))), t(rng.integers(4, 60, (6, 6))),
                t(rng.integers(4, 60, (2, 8))), t(rng.integers(0, 20, (2,))))
model = build_model(cfg, device="cpu")
vectors, tokens, attention = make_eval_step(model, Config(model=cfg))(batch)
assert tokens.shape == (6, 8) and torch.isfinite(vectors["sa_score"]).all()
state, m = make_train_step(model, Config(model=cfg))(
    create_train_state(model), batch, torch.Generator().manual_seed(0))
assert state.step == 1 and torch.isfinite(m["total"])
flat = QABatch(pack_graphs([sample(5, 9), sample(7, 14)], 16, 32, max_steps=3),
               *[getattr(batch, f) for f in ("questions", "programs",
                                             "full_answers",
                                             "short_answer_label")])
vectors, tokens, attention = make_eval_step(model, Config(model=cfg))(flat)
assert tokens.shape == (6, 8) and torch.isfinite(vectors["sa_score"]).all()
assert re.fullmatch(r"native \(.+\)|numpy", packer_name())
assert not any(sys.modules.get(n) for n in ("jax", "flax", "graphvqa_tpu"))
print("port ok")
"""
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "port ok" in proc.stdout


def test_entry_points_default_to_the_gpu_and_raise_without_one(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = port_model_config(tiny_model_config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(cfg)
    batch = port_batch(random_qa_batch(cfg=tiny_model_config(), dense=True))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        batch.to()
