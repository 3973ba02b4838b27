"""Per-module parity of the port against the JAX modules.

Widths are ``tests/helpers.py:tiny_model_config()``'s, in float32 with
dropout off. Weights cross from the JAX variables through
``from_jax_variables``; inputs are made with numpy from a seed. Comparisons
cover real rows only. Tolerances: rtol/atol 1e-5 for the single layers,
1e-4 for the stacks (float32 sums taken in another order, compounded over
the layers); greedy tokens must be equal.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvqa_tpu.core.packing as jpacking
import graphvqa_tpu.ops.dense as jdense
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.nn.embedding import PaddedEmbed as JaxPaddedEmbed
from graphvqa_tpu.nn.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from graphvqa_tpu.nn.transformer import causal_mask as jax_causal_mask
import graphvqa_tpu_torch.nn.gnn as pgnn
import graphvqa_tpu_torch.ops.dense as pdense
from graphvqa_tpu_torch.core import packing
from graphvqa_tpu_torch.nn.embedding import PaddedEmbed
from graphvqa_tpu_torch.nn.norm import MaskedBatchNorm
from graphvqa_tpu_torch.nn.transformer import causal_mask
from tests.torch_port_fixtures import tiny_gat_seq
from tests.torch_port_helpers import (
    jax_variables, port_graph, port_model, random_qa_batch, tiny_model_config)

STACK_TOL = dict(rtol=1e-4, atol=1e-4)
LAYER_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def setup():
    cfg = tiny_model_config()
    variables = jax_variables(cfg)
    jb = random_qa_batch(seed=3, num_graphs=3, cfg=cfg, dense=True)
    return dict(cfg=cfg, variables=variables, jax_model=JaxPipelineModel(cfg),
                model=port_model(cfg, variables), jb=jb,
                graph=port_graph(jb.graphs), rng=np.random.default_rng(7))


def _jax(s, fn, *args):
    return s["jax_model"].apply(s["variables"], *args, method=fn)


def _close(got, want, mask=None, tol=STACK_TOL):
    got = got.detach().float().numpy()
    want = np.asarray(want, dtype=np.float32)
    if mask is not None:
        got, want = got[mask], want[mask]
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("pick,ladder", [
    ("pick_dense_npg", "DEFAULT_DENSE_NPG"),
    ("pick_dense_epg", "DEFAULT_DENSE_EPG")])
def test_dense_ladder_pickers(pick, ladder):
    assert getattr(packing, ladder) == getattr(jpacking, ladder)
    got_fn, want_fn = getattr(packing, pick), getattr(jpacking, pick)
    for size in (0, 1, 16, 17, 64, 65, 128, 129, 256, 1000, 1024, 1025):
        try:
            want = want_fn(size)
        except ValueError:
            with pytest.raises(ValueError, match="exceeds the dense ladder"):
                got_fn(size)
        else:
            assert got_fn(size) == want


@pytest.mark.parametrize("length", [1, 5, 16])
def test_causal_mask(length):
    np.testing.assert_array_equal(causal_mask(length).numpy(),
                                  np.asarray(jax_causal_mask(length)))


def test_bag_sum():
    rng = np.random.default_rng(0)
    table = rng.normal(size=(40, 12)).astype(np.float32)
    ids = rng.integers(0, 40, size=(9, 5)).astype(np.int32)
    ids[0] = 1                                      # an all-pad row
    want = JaxPaddedEmbed(40, 12).apply(
        {"params": {"embedding": jnp.asarray(table)}}, jnp.asarray(ids),
        method="bag_sum")
    emb = PaddedEmbed(40, 12)
    emb.weight.data = torch.from_numpy(table)
    _close(emb.bag_sum(torch.from_numpy(ids)), want, tol=LAYER_TOL)


def test_masked_batch_norm_eval():
    rng = np.random.default_rng(1)
    C = 12
    x = rng.normal(size=(10, C)).astype(np.float32)
    mask = rng.random(10) > 0.3
    p = {k: rng.normal(size=C).astype(np.float32) for k in ("scale", "bias")}
    st = {"mean": rng.normal(size=C).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    want = JaxMaskedBatchNorm(C).apply(
        {"params": p, "batch_stats": st}, jnp.asarray(x),
        mask=jnp.asarray(mask), use_running_average=True)
    bn = MaskedBatchNorm(C)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(st["mean"]),
                        "running_var": torch.from_numpy(st["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn(torch.from_numpy(x), mask=torch.from_numpy(mask))
    _close(got, want, tol=LAYER_TOL)


def test_scene_graph_encoder(setup):
    s = setup
    x_want, e_want = _jax(s, lambda m, g: m.scene_graph_encoder(g),
                          s["jb"].graphs)
    x_got, e_got = s["model"].scene_graph_encoder(s["graph"])
    _close(x_got, x_want, np.asarray(s["jb"].graphs.node_mask))
    _close(e_got, e_want, np.asarray(s["jb"].graphs.edge_mask))


def test_question_encoder(setup):
    s = setup
    want = _jax(s, lambda m, q: m.question_encoder(q), s["jb"].questions)
    got = s["model"].question_encoder(
        torch.from_numpy(np.array(s["jb"].questions)),
        s["model"].text_vocab_embedding)
    _close(got, want)


def _gat_seq_case(s, shift, monkeypatch):
    """GATSeq against the JAX engine with both sides' softmax shift set to
    ``shift`` (each package reads GRAPHVQA_SOFTMAX_SHIFT at import)."""
    monkeypatch.setattr(jdense, "_SOFTMAX_SHIFT", shift)
    monkeypatch.setattr(pdense, "SOFTMAX_SHIFT", shift)
    rng, g, cfg = s["rng"], s["graph"], s["cfg"]
    C, D = cfg.scene.emb_dim, cfg.transformer.hidden_dim
    R = cfg.engine.num_rounds
    x = rng.normal(size=(g.nodes_pad, C)).astype(np.float32)
    e = rng.normal(size=(g.edges_pad, C)).astype(np.float32)
    ins = rng.normal(size=(R, g.num_graphs, D)).astype(np.float32)
    want = _jax(s, lambda m, *a: m.engine(*a, deterministic=True,
                                          use_running_average=True),
                s["jb"].graphs, jnp.asarray(x), jnp.asarray(e),
                jnp.asarray(ins))
    got = s["model"].gat_seq(g, torch.from_numpy(x), torch.from_numpy(e),
                             torch.from_numpy(ins))
    _close(got, want, np.asarray(s["jb"].graphs.node_mask))


def test_gat_seq_with_running_stats(setup, monkeypatch):
    _gat_seq_case(setup, jdense._SOFTMAX_SHIFT, monkeypatch)


def test_gat_seq_dst_shift(setup, monkeypatch):
    _gat_seq_case(setup, "dst", monkeypatch)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_gat_layer_hands_the_kernel_contiguous_tensors(dtype, monkeypatch):
    """Every tensor GATLayer passes to gat_round is contiguous and of the
    wrapper's documented dtype: the kernel on the card raises otherwise,
    while the plain version on the CPU would accept views."""
    calls = []

    def spy(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw, ins_value, **kw):
        named = dict(dl=dl, sl=sl, mask=mask, alpha_l=alpha_l,
                     alpha_r=alpha_r, alpha_e=alpha_e, xw=xw,
                     ins_value=ins_value)
        want = dict(dl=(torch.int32,), sl=(torch.int32,),
                    mask=(torch.float32,), alpha_l=(torch.float32,),
                    alpha_r=(torch.float32,),
                    alpha_e=(torch.float32, dtype),   # the wrapper casts it
                    xw=(dtype,), ins_value=(dtype,))
        for name, t in named.items():
            assert t.is_contiguous(), f"{name} is not contiguous"
            assert t.dtype in want[name], f"{name} has dtype {t.dtype}"
        calls.append(xw.shape)
        return real_gat_round(dl, sl, mask, alpha_l, alpha_r, alpha_e, xw,
                                ins_value, **kw)

    real_gat_round = pgnn.gat_round
    monkeypatch.setattr(pgnn, "gat_round", spy)
    seq, g, x, e, ins = tiny_gat_seq(dtype)
    with torch.no_grad():
        out = seq(g, x, e, ins)
    assert len(calls) == seq.num_rounds
    assert torch.isfinite(out.float()).all()


def test_conditional_pooling(setup):
    s, rng = setup, setup["rng"]
    g, cfg = s["graph"], s["cfg"]
    x = rng.normal(size=(g.nodes_pad, cfg.scene.emb_dim)).astype(np.float32)
    u = rng.normal(size=(g.num_graphs,
                         cfg.transformer.hidden_dim)).astype(np.float32)
    out_want, gate_want = _jax(s, lambda m, *a: m.pooling(*a),
                               s["jb"].graphs, jnp.asarray(x), jnp.asarray(u))
    out_got, gate_got = s["model"].graph_global_attention_pooling(
        g, torch.from_numpy(x), torch.from_numpy(u))
    _close(out_got, out_want)
    _close(gate_got, gate_want, np.asarray(s["jb"].graphs.node_mask))


def test_greedy_samplers_emit_equal_tokens(setup):
    s, rng = setup, setup["rng"]
    cfg = s["cfg"]
    memory = rng.normal(size=(3, 7, cfg.transformer.hidden_dim)).astype(
        np.float32)
    prog_want, instr_want = _jax(
        s, lambda m, mem: m.program_decoder.sample(mem), jnp.asarray(memory))
    fa_want = _jax(s, lambda m, mem: m.full_answer_decoder.sample(mem),
                   jnp.asarray(memory))
    model, mem = s["model"], torch.from_numpy(memory)
    with torch.no_grad():
        prog_got, instr_got = model.program_decoder.sample(
            mem, model.text_vocab_embedding)
        fa_got = model.full_answer_decoder.sample(
            mem, model.text_vocab_embedding)
    np.testing.assert_array_equal(prog_got.numpy(), np.asarray(prog_want))
    np.testing.assert_array_equal(fa_got.numpy(), np.asarray(fa_want))
    _close(instr_got, instr_want)


# --- the flat layout (a batch beyond the dense ladder) ----------------------

@pytest.fixture(scope="module")
def flat_setup(setup):
    jb = random_qa_batch(seed=4, num_graphs=3, cfg=setup["cfg"], dense=False,
                         nodes_pad=32, edges_pad=64)
    return dict(setup, jb=jb, graph=port_graph(jb.graphs),
                rng=np.random.default_rng(8))


def test_flat_scene_graph_encoder(flat_setup):
    """The MetaLayer's index ops on the flat layout, then the segment
    LayerNorm."""
    s = flat_setup
    assert not s["graph"].has_dense_layout
    test_scene_graph_encoder(s)


def test_flat_gat_seq_folds_the_instruction_into_every_node(flat_setup,
                                                           monkeypatch):
    """JAX's flat round adds the instruction's projection to every node's
    (no ins_value share through the attention row sums); the port follows
    it on the flat layout and keeps the share on the dense one."""
    calls = []
    monkeypatch.setattr(pgnn, "gat_round",
                        lambda *a, **k: calls.append(1) or None)
    _gat_seq_case(flat_setup, jdense._SOFTMAX_SHIFT, monkeypatch)
    assert calls == []


def test_flat_conditional_pooling(flat_setup):
    test_conditional_pooling(flat_setup)
