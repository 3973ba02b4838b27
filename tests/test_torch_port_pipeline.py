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
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.models.pipeline import PipelineModel
from tests.torch_port_helpers import (
    CONVERTER_KIND, execution_engine_params, jax_init_shapes, jax_variables,
    port_batch, port_model, port_model_config, random_qa_batch,
    tiny_model_config)

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
    from graphvqa_tpu.config import CONFIG_FACTORY as JAX_FACTORY
    assert set(pcfg.CONFIG_FACTORY) == set(JAX_FACTORY) == {
        "gat", "gcn", "gine", "lcgn", "onlysg"}
    for name, factory in JAX_FACTORY.items():
        want = dataclasses.asdict(factory())
        got = dataclasses.asdict(pcfg.CONFIG_FACTORY[name]())
        assert got["model"] == want["model"], name
        assert got["batch"] == want["batch"], name
        assert got["train"] == want["train"], name


def _family_cfg(name):
    kind = {"onlysg": "none", "gat_exec": "gat"}.get(name, name)
    return tiny_model_config(kind, use_execution_engine=name == "gat_exec")


@pytest.mark.parametrize("name,pyg", [
    ("gcn", "1.x"), ("gcn", "2.0"), ("gine", None), ("lcgn", None),
    ("onlysg", None), ("gat_exec", None)])
def test_family_weights_round_trip_through_reference_names(name, pyg):
    """port state_dict -> the JAX package's converter (gcn in PyG 1.x's
    ``convs.i.weight`` [in, out] and >= 2.0's ``convs.i.lin.weight``
    [out, in] layouts) == the JAX variables -> ``from_jax_variables`` ==
    the port state_dict; the tree matches what ``PipelineModel.init``
    makes."""
    cfg = _family_cfg(name)
    variables = jax_variables(cfg, seed=2)
    model = port_model(cfg, variables)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    ref = dict(sd)
    if pyg == "2.0":
        for i in range(cfg.engine.num_rounds):
            ref[f"gcn_seq.convs.{i}.lin.weight"] = ref.pop(
                f"gcn_seq.convs.{i}.weight").T.copy()
    L = cfg.transformer.num_layers
    back = convert_pipeline(ref, kind=CONVERTER_KIND[cfg.engine.kind],
                            num_encoder_layers=L, num_decoder_layers=L,
                            num_rounds=cfg.engine.num_rounds,
                            lcgn_iters=cfg.engine.lcgn_iters)
    if cfg.use_execution_engine:
        back["params"]["execution_engine"] = execution_engine_params(sd)
    want_leaves, want_def = jax.tree.flatten(variables)
    got_leaves, got_def = jax.tree.flatten(back)
    assert got_def == want_def
    for g, w in zip(got_leaves, want_leaves):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    again = from_jax_variables(back, cfg.engine.kind)
    assert set(again) == set(sd)
    for k, v in again.items():
        np.testing.assert_array_equal(v.numpy(), sd[k], err_msg=k)
    shapes = jax.tree.map(lambda a: tuple(np.shape(a)), variables)
    init = jax_init_shapes(cfg)
    assert shapes == {"params": init["params"],
                      "batch_stats": init.get("batch_stats", {})}


def test_reference_lcgn_state_dict_with_dead_bns_loads():
    """The reference's ``lcgn_seq.bns`` are never read by its forward: a
    reference-named state dict that carries them loads (they are dropped)."""
    cfg = port_model_config(_family_cfg("lcgn"))
    model = PipelineModel(cfg)
    sd = dict(model.state_dict())
    for i in range(cfg.engine.lcgn_iters):
        sd[f"lcgn_seq.bns.{i}.weight"] = torch.ones(4)
        sd[f"lcgn_seq.bns.{i}.running_var"] = torch.ones(4)
        sd[f"lcgn_seq.bns.{i}.num_batches_tracked"] = torch.tensor(3)
    fresh = PipelineModel(cfg)
    fresh.load_state_dict(sd)
    assert not any("bns" in k for k in fresh.state_dict())
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k


def test_gine_nonzero_eps_rejected_by_the_port():
    """As the JAX converter refuses a trained GINE eps, so does the port's
    load_state_dict; eps 0 loads."""
    cfg = port_model_config(_family_cfg("gine"))
    sd = dict(PipelineModel(cfg).state_dict())
    PipelineModel(cfg).load_state_dict(sd)
    sd["gine_seq.convs.1.eps"] = torch.tensor([0.3])
    with pytest.raises(ValueError, match="eps"):
        PipelineModel(cfg).load_state_dict(sd)
    with pytest.raises(ValueError, match="eps"):
        convert_pipeline({k: v.numpy() for k, v in sd.items()}, kind="gine",
                         num_encoder_layers=cfg.transformer.num_layers,
                         num_decoder_layers=cfg.transformer.num_layers,
                         num_rounds=cfg.engine.num_rounds)


def test_port_runs_without_jax_flax_or_the_jax_package():
    code = """
import dataclasses
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
import graphvqa_tpu_torch.nn.execution
import graphvqa_tpu_torch.ops.dispatch
import graphvqa_tpu_torch.ops.layernorm
from graphvqa_tpu_torch.config import (
    CONFIG_FACTORY, Config, EngineConfig, ModelConfig, SceneGraphConfig,
    TextConfig, TransformerConfig)
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
for name, factory in CONFIG_FACTORY.items():
    for exe in (False, True):
        mc = dataclasses.replace(
            cfg.replace_engine(factory().model.engine.kind),
            use_execution_engine=exe)
        fam = build_model(mc, device="cpu")
        fcfg = Config(model=mc, train=factory().train)
        ctx = torch.Generator().manual_seed(1)
        for b in (batch, flat):
            vectors, tokens, _ = make_eval_step(fam, fcfg)(b, ctx)
            assert torch.isfinite(vectors["sa_score"]).all()
            assert ("execution_bitmap" in vectors) == exe
        _, m = make_train_step(fam, fcfg)(
            create_train_state(fam), batch, torch.Generator().manual_seed(0),
            ctx)
        assert torch.isfinite(m["total"]), name
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
