"""The port's train slice against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port. Tolerances, float32 unless stated:
  * GAT-round backward (the plain version of the backward kernel) against
    ``jax.vjp`` of ``ops/dense.py:dense_gat_aggregate`` and against
    torch.autograd through ``gat_round_reference``: rtol/atol 1e-5 (the same
    sums in another order). bfloat16 inputs against ``jax.vjp``: atol 2e-2
    of the output's scale (JAX rounds the attention matrix to bf16), where
    d_alpha_l and d_alpha_r take d_alpha_e's scale: they are sums of
    per-edge terms that nearly cancel.
  * single modules: rtol/atol 1e-5; the decoder stacks 1e-4.
  * one whole train step against ``make_train_step``: loss and metrics rtol
    1e-5; every gradient within 1e-5 of its tensor's largest |gradient|
    plus an atol of 5e-8 (gradients that are 0 in exact arithmetic, the GAT
    biases before a BatchNorm and the attention key biases, come out as f32
    round-off of 1e-9 to 1.3e-8); updated parameters within 1e-6 where |grad| >
    1e-6 (well above Adam's eps of 1e-8; where |grad| is near eps the first
    Adam step is ill-conditioned and only the bound |diff| <= 2 lr holds);
    BatchNorm running statistics rtol/atol 1e-5.
  * the bfloat16 step: loss within 5e-2, running statistics within 5e-2.
Dropout cannot match JAX's bits, so parity runs with every rate at 0 and
dropout gets its own tests (kept share, scale, determinism).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import graphvqa_tpu.ops.dense as jdense
import graphvqa_tpu_torch.config as pcfg
import graphvqa_tpu_torch.ops.dense as pdense
from graphvqa_tpu.config import Config as JaxConfig
from graphvqa_tpu.config import TrainConfig as JaxTrainConfig
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.nn.norm import MaskedBatchNorm as JaxMaskedBatchNorm
from graphvqa_tpu.nn.transformer import (
    block_causal_mask as jax_block_causal_mask)
from graphvqa_tpu.train import losses as jlosses
from graphvqa_tpu.train import metrics as jmetrics
from graphvqa_tpu.train.loop import make_train_step as jax_make_train_step
from graphvqa_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from graphvqa_tpu.train.train_state import step_lr as jax_step_lr
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.nn.norm import MaskedBatchNorm
from graphvqa_tpu_torch.nn.transformer import block_causal_mask, dropout
from graphvqa_tpu_torch.ops.cuda_lib import KINDS, launch_counts
from graphvqa_tpu_torch.ops.gat_round import (
    gat_round, gat_round_backward, gat_round_backward_reference,
    gat_round_reference)
from graphvqa_tpu_torch.train import losses, metrics
from graphvqa_tpu_torch.train.checkpoint import (
    restore_checkpoint, save_checkpoint)
from graphvqa_tpu_torch.train.loop import make_train_step
from graphvqa_tpu_torch.train.train_state import (
    create_train_state, step_lr)
from tests.test_torch_port_gat_round import _case, _port_inputs
from tests.torch_port_fixtures import tiny_gat_seq
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_model, port_model_config,
    random_qa_batch, tiny_model_config)

TOL = dict(rtol=1e-5, atol=1e-5)
STACK_TOL = dict(rtol=1e-4, atol=1e-4)
LR, WD = 1e-3, 1e-2


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, transformer=dataclasses.replace(cfg.transformer, dropout=0.0),
        engine=dataclasses.replace(cfg.engine, dropout=0.0),
        classifier_dropout=0.0)


# --- the GAT round's backward ----------------------------------------------

def _vjp_case(shift, with_ins, dtype, monkeypatch):
    monkeypatch.setattr(jdense, "_SOFTMAX_SHIFT", shift)
    _, jg, a = _case(8, 16, seed=3)
    N, C = jg.num_graphs * 8, a["xw"].shape[2]
    grad = np.random.default_rng(9).normal(size=(N, C)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    ins = jnp.asarray(a["ins"], jdt) if with_ins else None

    def f(xw, al, ar, ae, ins):
        return jdense.dense_gat_aggregate(jg, xw, al, ar, ae,
                                          ins_value=ins)[0]

    primals = (jnp.asarray(a["xw"], jdt), jnp.asarray(a["al"]),
               jnp.asarray(a["ar"]), jnp.asarray(a["ae"]), ins)
    _, vjp = jax.vjp(f, *primals)
    want = vjp(jnp.asarray(grad, jdt))
    _, args = _port_inputs(jg, a)
    args = args[:6] + (args[6].to(dtype),)
    t_ins = torch.from_numpy(a["ins"]).to(dtype) if with_ins else None
    return jg, args, t_ins, torch.from_numpy(grad).to(dtype), want


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("with_ins", [False, True])
@pytest.mark.parametrize("shift", ["graph", "dst"])
def test_backward_plain_version_matches_jax_vjp(shift, with_ins, dtype,
                                                monkeypatch):
    _, args, ins, grad, want = _vjp_case(shift, with_ins, dtype, monkeypatch)
    got = gat_round_backward_reference(grad, *args, ins, npg=8, epg=16,
                                       shift=shift)
    B, epg, H = args[5].shape
    got = (got[0], got[1], got[2], got[3].reshape(B * epg, H), got[4])
    edge_scale = np.abs(np.asarray(want[3], np.float32)).max()
    for name, g, w in zip(("xw", "al", "ar", "ae", "ins"), got, want):
        if w is None:
            assert g is None
            continue
        w = np.asarray(w, np.float32)
        g = g.float().numpy()
        if dtype == torch.float32:
            np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        else:
            scale = edge_scale if name in ("al", "ar") else np.abs(w).max()
            np.testing.assert_allclose(g, w, rtol=0, err_msg=name,
                                       atol=2e-2 * scale)


@pytest.mark.parametrize("with_keep", [False, True])
@pytest.mark.parametrize("with_ins", [False, True])
@pytest.mark.parametrize("shift", ["graph", "dst"])
def test_backward_plain_version_matches_autograd(shift, with_ins, with_keep,
                                                 monkeypatch):
    """Closed form against torch.autograd through the forward twin,
    with and without the dropout scale; also through gat_round's
    autograd.Function on the CPU."""
    _, args, ins, grad, _ = _vjp_case(shift, with_ins, torch.float32,
                                      monkeypatch)
    keep = None
    if with_keep:
        rng = np.random.default_rng(4)
        keep = torch.from_numpy(
            (rng.random(args[5].shape) >= 0.3).astype(np.float32) / 0.7)
    want = gat_round_backward_reference(grad, *args, ins, keep, npg=8,
                                        epg=16, shift=shift)
    for fn in (gat_round_reference, gat_round):
        leaves = [a.clone().requires_grad_(True) for a in args[3:]]
        ins_ = None if ins is None else ins.clone().requires_grad_(True)
        out = fn(*args[:3], *leaves, ins_, npg=8, epg=16, shift=shift,
                 keep_scale=keep)
        out.backward(grad)
        got = (leaves[3].grad, leaves[0].grad, leaves[1].grad,
               leaves[2].grad, None if ins_ is None else ins_.grad)
        for g, w in zip(got, want):
            if w is None:
                continue
            torch.testing.assert_close(g, w, **TOL)


def test_backward_wrapper_runs_plain_version_on_cpu():
    _, jg, a = _case(8, 16, seed=4)
    _, args = _port_inputs(jg, a)
    grad = torch.ones(args[6].shape[0], args[6].shape[2])
    before = launch_counts()
    got = gat_round_backward(grad, *args, npg=8, epg=16)
    want = gat_round_backward_reference(grad, *args, npg=8, epg=16)
    for g, w in zip(got[:4], want[:4]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    assert got[4] is None
    assert launch_counts() == before == dict.fromkeys(KINDS, 0)


def test_padded_rows_and_edges_get_zero_gradients():
    _, jg, a = _case(8, 16, seed=6)
    g, args = _port_inputs(jg, a)
    grad = torch.from_numpy(np.random.default_rng(1).normal(
        size=(g.nodes_pad, a["xw"].shape[2])).astype(np.float32))
    d_xw, d_al, d_ar, d_ae, d_ins = gat_round_backward_reference(
        grad, *args, torch.from_numpy(a["ins"]), npg=8, epg=16)
    pad_nodes = ~g.node_mask
    pad_edges = ~g.edge_mask
    assert (d_xw[pad_nodes] == 0).all() and (d_al[pad_nodes] == 0).all()
    assert (d_ar[pad_nodes] == 0).all()
    assert (d_ae.reshape(-1, d_ae.shape[-1])[pad_edges] == 0).all()


def test_forward_attention_output_matches_jax(monkeypatch):
    """return_alpha: the attention [E, H] of dense_gat_aggregate."""
    monkeypatch.setattr(jdense, "_SOFTMAX_SHIFT", "graph")
    _, jg, a = _case(8, 16, seed=7)
    _, want = jdense.dense_gat_aggregate(
        jg, jnp.asarray(a["xw"]), jnp.asarray(a["al"]), jnp.asarray(a["ar"]),
        jnp.asarray(a["ae"]), return_alpha=True)
    _, args = _port_inputs(jg, a)
    _, got = gat_round(*args, npg=8, epg=16, return_alpha=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- modules ----------------------------------------------------------------

@pytest.mark.parametrize("blocks,length", [(1, 4), (3, 5), (5, 15)])
def test_block_causal_mask(blocks, length):
    np.testing.assert_array_equal(
        block_causal_mask(blocks, length).numpy(),
        np.asarray(jax_block_causal_mask(blocks, length)))


def test_masked_batch_norm_batch_statistics():
    rng = np.random.default_rng(1)
    C = 12
    x = rng.normal(size=(10, C)).astype(np.float32) * 2 + 1
    mask = rng.random(10) > 0.3
    p = {k: rng.normal(size=C).astype(np.float32) for k in ("scale", "bias")}
    st = {"mean": rng.normal(size=C).astype(np.float32),
          "var": rng.uniform(0.5, 2.0, C).astype(np.float32)}
    want, mutated = JaxMaskedBatchNorm(C).apply(
        {"params": p, "batch_stats": st}, jnp.asarray(x),
        mask=jnp.asarray(mask), use_running_average=False,
        mutable=["batch_stats"])
    bn = MaskedBatchNorm(C)
    bn.load_state_dict({"weight": torch.from_numpy(p["scale"]),
                        "bias": torch.from_numpy(p["bias"]),
                        "running_mean": torch.from_numpy(st["mean"]),
                        "running_var": torch.from_numpy(st["var"]),
                        "num_batches_tracked": torch.tensor(0)})
    got = bn(torch.from_numpy(x), mask=torch.from_numpy(mask),
             use_running_average=False)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    new = mutated["batch_stats"]
    np.testing.assert_allclose(bn.running_mean.numpy(),
                               np.asarray(new["mean"]), **TOL)
    np.testing.assert_allclose(bn.running_var.numpy(),
                               np.asarray(new["var"]), **TOL)


@pytest.fixture(scope="module")
def tiny():
    cfg = _no_dropout(tiny_model_config())
    variables = jax_variables(cfg)
    return dict(cfg=cfg, variables=variables,
                jax_model=JaxPipelineModel(cfg),
                model=port_model(cfg, variables))


def test_teacher_forced_decoders(tiny):
    cfg, model = tiny["cfg"], tiny["model"]
    rng = np.random.default_rng(2)
    B, M, D, V = 3, cfg.max_execution_steps, cfg.transformer.hidden_dim, \
        cfg.text.vocab_size
    memory = rng.normal(size=(B, 7, D)).astype(np.float32)
    programs = rng.integers(4, V, size=(B * M, 6)).astype(np.int32)
    answers = rng.integers(4, V, size=(B, 8)).astype(np.int32)
    programs[:, 4:] = cfg.text.pad_idx

    def jax_apply(fn, *args):
        return tiny["jax_model"].apply(tiny["variables"], *args, method=fn)

    want_logits, want_instr = jax_apply(
        lambda m, *a: m.program_decoder(*a), jnp.asarray(memory),
        jnp.asarray(programs))
    want_fa = jax_apply(lambda m, *a: m.full_answer_decoder(*a),
                        jnp.asarray(memory), jnp.asarray(answers))
    emb, mem = model.text_vocab_embedding, torch.from_numpy(memory)
    with torch.no_grad():
        got_logits, got_instr = model.program_decoder(
            mem, torch.from_numpy(programs), emb)
        got_fa = model.full_answer_decoder(mem, torch.from_numpy(answers),
                                           emb)
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               **STACK_TOL)
    np.testing.assert_allclose(got_instr.numpy(), np.asarray(want_instr),
                               **STACK_TOL)
    np.testing.assert_allclose(got_fa.numpy(), np.asarray(want_fa),
                               **STACK_TOL)


# --- losses, metrics, optimizer ---------------------------------------------

def test_losses():
    rng = np.random.default_rng(3)
    logits = rng.normal(size=(6, 11)).astype(np.float32)
    labels = rng.integers(0, 11, size=6).astype(np.int32)
    tok_logits = rng.normal(size=(4, 5, 11)).astype(np.float32)
    targets = rng.integers(0, 11, size=(4, 5)).astype(np.int32)
    targets[:, 3:] = 1
    pred = rng.uniform(0.01, 0.99, size=(9, 3)).astype(np.float32)
    true = (rng.random((9, 3)) > 0.5).astype(np.float32)
    node_mask = rng.random(9) > 0.3
    t, j = torch.from_numpy, jnp.asarray
    pairs = [
        (losses.cross_entropy(t(logits), t(labels)),
         jlosses.cross_entropy(j(logits), j(labels))),
        (losses.masked_token_cross_entropy(t(tok_logits), t(targets), 1),
         jlosses.masked_token_cross_entropy(j(tok_logits), j(targets), 1)),
        (losses.bitmap_bce(t(pred), t(true), t(node_mask)),
         jlosses.bitmap_bce(j(pred), j(true), j(node_mask)))]
    for got, want in pairs:
        np.testing.assert_allclose(float(got), float(want), **TOL)


def test_train_metrics():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(8, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=8).astype(np.int32)
    target = rng.integers(0, 4, size=(10, 6)).astype(np.int32)
    pred = target.copy()
    pred[::3, 1] += 1
    target[1::4, 2:] = 1
    t, j = torch.from_numpy, jnp.asarray
    for k in (1, 3):
        got = metrics.topk_accuracy(t(logits), t(labels), k)
        want = jmetrics.topk_accuracy(j(logits), j(labels), k)
        assert [int(x) for x in got] == [int(x) for x in want]
    got = metrics.string_exact_match_acc(t(pred), t(target), 1)
    want = jmetrics.string_exact_match_acc(j(pred), j(target), 1)
    assert [int(x) for x in got] == [int(x) for x in want]
    got = metrics.program_string_exact_match_acc(t(pred), t(target), 1, 5)
    want = jmetrics.program_string_exact_match_acc(j(pred), j(target), 1, 5)
    assert [[int(x) for x in p] for p in got] == [
        [int(x) for x in p] for p in want]


@pytest.mark.parametrize("epoch", [0, 89, 90, 181])
def test_step_lr(epoch):
    np.testing.assert_allclose(step_lr(1e-4, 90, 0.1, epoch),
                               float(jax_step_lr(1e-4, 90, 0.1, epoch)),
                               rtol=1e-6)


@pytest.mark.parametrize("clip_grad", [0.0, 0.5, 100.0])
@pytest.mark.parametrize("weight_decay", [0.0, 0.05])
def test_optimizer_matches_optax(weight_decay, clip_grad):
    """Three steps of clipping -> Adam -> decoupled decay -> -lr on fixed
    gradients, one parameter without any, against the JAX state's optax
    chain; the epoch moves past lr_drop before the last step."""
    rng = np.random.default_rng(5)
    shapes = {"a": (3, 4), "b": (5,), "z": (2, 2)}
    params = {k: rng.normal(size=s).astype(np.float32)
              for k, s in shapes.items()}
    grads = [{k: rng.normal(size=s).astype(np.float32) * 0.3
              for k, s in shapes.items() if k != "z"} for _ in range(3)]
    jstate = jax_create_train_state(
        {"params": jax.tree.map(jnp.asarray, params)}, lr=1e-2, lr_drop=2,
        weight_decay=weight_decay, clip_grad=clip_grad)
    module = torch.nn.ParameterDict(
        {k: torch.nn.Parameter(torch.from_numpy(v.copy()))
         for k, v in params.items()})
    state = create_train_state(module, lr=1e-2, lr_drop=2,
                               weight_decay=weight_decay, clip_grad=clip_grad)
    for i, g in enumerate(grads):
        if i == 2:
            jstate, state = jstate.next_epoch().next_epoch(), \
                state.next_epoch().next_epoch()
        full = {k: g.get(k, np.zeros(s, np.float32))
                for k, s in shapes.items()}
        jstate = jstate.apply_gradients(jax.tree.map(jnp.asarray, full))
        state.apply_gradients({k: torch.from_numpy(v) for k, v in g.items()})
    for k in shapes:
        np.testing.assert_allclose(module[k].detach().numpy(),
                                   np.asarray(jstate.params[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)
    assert state.step == int(jstate.step) == 3
    optax_global_norm = float(optax.global_norm(
        {k: jnp.asarray(v) for k, v in grads[0].items()}))
    assert optax_global_norm > 0.5       # the 0.5 clip triggers


# --- the whole step -----------------------------------------------------------

def _jax_step(cfg, variables, jb, train_cfg):
    """JAX's make_train_step from the same weights, and its gradients."""
    jvars = jax.tree.map(jnp.asarray, variables)
    jmodel = JaxPipelineModel(cfg)
    state = jax_create_train_state(jvars, lr=LR, weight_decay=WD)
    model_in = jb.replace(programs=jb.programs[:, :-1],
                          full_answers=jb.full_answers[:, :-1])

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": jvars["batch_stats"]},
            model_in, sample=False, deterministic=False,
            use_running_average=False,
            rngs={"dropout": jax.random.key(0)}, mutable=["batch_stats"])
        return jlosses.total_loss(
            out, jb.programs[:, 1:], jb.full_answers[:, 1:],
            jb.short_answer_label, cfg.text.pad_idx)[0]

    grads = jax.jit(jax.grad(loss_fn))(jvars["params"])
    new, m = jax_make_train_step(jmodel, JaxConfig(
        model=cfg, train=train_cfg))(state, jb, jax.random.key(0))
    return grads, new, m


def _port_step(cfg, variables, jb, dtype=None):
    model = port_model(cfg, variables)
    state = create_train_state(model, lr=LR, weight_decay=WD)
    step = make_train_step(model, pcfg.Config(
        model=port_model_config(cfg),
        train=pcfg.TrainConfig(lr=LR, weight_decay=WD)))
    state, m = step(state, port_batch(jb), torch.Generator().manual_seed(0))
    return model, state, m


@pytest.fixture(scope="module")
def f32_step():
    cfg = _no_dropout(tiny_model_config())
    variables = jax_variables(cfg, seed=2)
    jb = random_qa_batch(seed=5, num_graphs=4, cfg=cfg, dense=True)
    grads, new, jm = _jax_step(cfg, variables, jb,
                               JaxTrainConfig(lr=LR, weight_decay=WD))
    model, state, m = _port_step(cfg, variables, jb)
    to_port = lambda params, stats: from_jax_variables(  # noqa: E731
        {"params": jax.device_get(params),
         "batch_stats": jax.device_get(stats)})
    return dict(want_grads=to_port(grads, variables["batch_stats"]),
                want_state=to_port(new.params, new.batch_stats),
                want_metrics=jm, model=model, metrics=m)


def test_train_step_loss_and_metrics_f32(f32_step):
    got, want = f32_step["metrics"], f32_step["want_metrics"]
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]),
                                   rtol=1e-5, err_msg=k)


def test_train_step_gradients_f32(f32_step):
    want = f32_step["want_grads"]
    params = dict(f32_step["model"].named_parameters())
    assert set(params) == {k for k in want if k in params}
    for name, p in params.items():
        w = want[name].numpy()
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max() + 5e-8,
                                   err_msg=name)


def test_train_step_updated_params_and_running_stats_f32(f32_step):
    want, model = f32_step["want_state"], f32_step["model"]
    grads = f32_step["want_grads"]
    sd = model.state_dict()
    for name, p in model.named_parameters():
        got, w = p.detach().numpy(), want[name].numpy()
        conditioned = np.abs(grads[name].numpy()) > 1e-6
        np.testing.assert_allclose(got[conditioned], w[conditioned], rtol=0,
                                   atol=1e-6, err_msg=name)
        assert np.abs(got - w).max() <= 2 * LR, name
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(),
                                       err_msg=name, **TOL)


def test_train_step_bf16():
    cfg = _no_dropout(tiny_model_config(dtype="bfloat16"))
    variables = jax_variables(cfg, seed=3)
    jb = random_qa_batch(seed=6, num_graphs=4, cfg=cfg, dense=True)
    jvars = jax.tree.map(jnp.asarray, variables)
    new, jm = jax_make_train_step(JaxPipelineModel(cfg), JaxConfig(
        model=cfg, train=JaxTrainConfig(lr=LR, weight_decay=WD)))(
        jax_create_train_state(jvars, lr=LR, weight_decay=WD), jb,
        jax.random.key(0))
    model, _, m = _port_step(cfg, variables, jb)
    assert np.isfinite(float(m["total"]))
    np.testing.assert_allclose(float(m["total"]), float(jm["total"]),
                               atol=5e-2)
    for k in ("short_answer_total", "program_total", "edge_count"):
        assert int(m[k]) == int(jm[k])
    want = from_jax_variables({"params": jax.device_get(new.params),
                               "batch_stats": jax.device_get(
                                   new.batch_stats)})
    sd = model.state_dict()
    for name in want:
        if name.endswith(("running_mean", "running_var")):
            np.testing.assert_allclose(sd[name].numpy(), want[name].numpy(),
                                       rtol=0, atol=5e-2, err_msg=name)


# --- dropout, training behaviour, checkpoints -------------------------------

def test_dropout_kept_share_scale_and_determinism():
    x = torch.ones(200_000)
    a = dropout(x, 0.25, torch.Generator().manual_seed(1))
    b = dropout(x, 0.25, torch.Generator().manual_seed(1))
    c = dropout(x, 0.25, torch.Generator().manual_seed(2))
    kept = a != 0
    share = float(kept.float().mean())
    # binomial: 3 standard deviations of the share are 0.003
    assert abs(share - 0.75) < 0.003
    assert torch.equal(a[kept], torch.full_like(a[kept], 1 / 0.75))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert dropout(x, 0.25, None) is x and dropout(x, 0.0, None) is x


def test_gat_seq_attention_dropout_is_seeded():
    seq, g, x, e, ins = tiny_gat_seq(torch.float32)
    seq.dropout = 0.5

    def run(seed):
        return seq(g, x, e, ins, generator=torch.Generator().manual_seed(
            seed), use_running_average=True, return_alpha=True)

    (h1, a1), (h2, a2), (h3, _) = run(0), run(0), run(1)
    assert torch.equal(h1, h2) and torch.equal(a1, a2)
    assert not torch.equal(h1, h3)
    assert a1.shape == (seq.num_rounds, g.edges_pad, seq.heads)
    # dropped edges carry zero attention; kept ones the rescaled weight
    assert (a1[:, ~g.edge_mask] == 0).all()


def _tiny_state(cfg, seed=0, lr=3e-3, use_program_loss=True):
    model = port_model(cfg, jax_variables(cfg, seed=seed))
    tc = pcfg.TrainConfig(lr=lr, use_program_loss=use_program_loss)
    state = create_train_state(model, lr=lr)
    return model, state, make_train_step(model, pcfg.Config(
        model=port_model_config(cfg), train=tc))


def test_train_step_is_deterministic_under_a_seeded_generator():
    cfg = tiny_model_config()                  # dropout on
    batch = port_batch(random_qa_batch(seed=8, num_graphs=3, cfg=cfg,
                                       dense=True))
    runs = []
    for seed in (0, 0, 1):
        model, state, step = _tiny_state(cfg)
        _, m = step(state, batch, torch.Generator().manual_seed(seed))
        runs.append((float(m["total"]), [p.detach().clone()
                                         for p in model.parameters()]))
    assert runs[0][0] == runs[1][0] != runs[2][0]
    assert all(torch.equal(a, b) for a, b in zip(runs[0][1], runs[1][1]))


def test_loss_decreases_overfit():
    """12 steps on one batch (program loss on, lr 3e-3, dropout on), as
    tests/test_train.py does for the JAX package."""
    cfg = tiny_model_config()
    batch = port_batch(random_qa_batch(seed=9, num_graphs=4, cfg=cfg,
                                       dense=True))
    _, state, step = _tiny_state(cfg)
    gen = torch.Generator().manual_seed(7)
    losses_ = []
    for _ in range(12):
        state, m = step(state, batch, gen)
        losses_.append(float(m["total"]))
    assert np.isfinite(losses_[-1])
    assert losses_[-1] < losses_[0] * 0.7, losses_


def test_checkpoint_round_trip(tmp_path):
    cfg = tiny_model_config()
    batch = port_batch(random_qa_batch(seed=10, num_graphs=2, cfg=cfg,
                                       dense=True))
    model, state, step = _tiny_state(cfg)
    state, _ = step(state, batch, torch.Generator().manual_seed(0))
    for epoch in (1, 2, 3):
        state.epoch = epoch
        save_checkpoint(tmp_path / "ckpt", state, keep=2)
    assert sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == [
        "ckpt_2.pt", "ckpt_3.pt"]
    fresh_model, fresh, _ = _tiny_state(cfg, seed=5)
    restored, start_epoch = restore_checkpoint(tmp_path / "ckpt", fresh)
    assert start_epoch == 4 and restored.epoch == 3 and restored.step == 1
    for (n, a), b in zip(model.state_dict().items(),
                         fresh_model.state_dict().values()):
        assert torch.equal(a, b), n
    for k in ("mu", "nu"):
        for n, v in state.opt_state[k].items():
            assert torch.equal(v, restored.opt_state[k][n])
    # a tolerant restore keeps the current value where a shape differs
    saved = torch.load(tmp_path / "ckpt" / "ckpt_3.pt", weights_only=True)
    name = "logit_fc.4.bias"
    saved["params"][name] = torch.zeros(7)
    torch.save(saved, tmp_path / "ckpt" / "ckpt_3.pt")
    other_model, other, _ = _tiny_state(cfg, seed=6)
    before = other_model.state_dict()[name].clone()
    restore_checkpoint(tmp_path / "ckpt", other)
    assert torch.equal(other_model.state_dict()[name], before)


def test_dst_shift_train_step_matches_jax(monkeypatch):
    """The 'dst' softmax shift through the whole step's gradients."""
    monkeypatch.setattr(jdense, "_SOFTMAX_SHIFT", "dst")
    monkeypatch.setattr(pdense, "SOFTMAX_SHIFT", "dst")
    cfg = _no_dropout(tiny_model_config())
    variables = jax_variables(cfg, seed=4)
    jb = random_qa_batch(seed=11, num_graphs=3, cfg=cfg, dense=True)
    jvars = jax.tree.map(jnp.asarray, variables)
    jmodel = JaxPipelineModel(cfg)
    model_in = jb.replace(programs=jb.programs[:, :-1],
                          full_answers=jb.full_answers[:, :-1])

    def loss_fn(params):
        out, _ = jmodel.apply(
            {"params": params, "batch_stats": jvars["batch_stats"]},
            model_in, sample=False, deterministic=False,
            use_running_average=False, rngs={"dropout": jax.random.key(0)},
            mutable=["batch_stats"])
        return jlosses.total_loss(out, jb.programs[:, 1:],
                                  jb.full_answers[:, 1:],
                                  jb.short_answer_label, 1)[0]

    want = from_jax_variables({"params": jax.device_get(
        jax.jit(jax.grad(loss_fn))(jvars["params"])),
        "batch_stats": variables["batch_stats"]})
    model, _, _ = _port_step(cfg, variables, jb)
    for name, p in model.named_parameters():
        if not name.startswith("gat_seq"):
            continue
        w = want[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max() + 5e-8,
                                   err_msg=name)
