"""The port's engine families (gcn, gine, lcgn, onlysg) and the recurrent
execution engine against the JAX package, on the CPU.

Inputs are made with numpy from a seed and go through the JAX function and
its port, in the dense and the flat layout. Only real rows are compared:
padded rows differ by design (``broadcast_to_nodes`` fills them, the flat
path zeroes them). Tolerances:
  * modules in float32: rtol/atol 1e-5 (the same sums in another order),
    the train tests' module bound;
  * modules in bfloat16 (one case per engine): within 5e-2 of the output's
    largest |value| (at least 1), the bf16 logits bound of the eval tests,
    because the two frameworks round at other places (XLA's bf16 segment
    sums against the port's float32 sums cast once). LCGN computes in
    float32 under the bf16 configuration in both packages, so its bf16 case
    keeps the float32 bound;
  * whole eval steps in float32 (``make_eval_step``): logits rtol/atol
    1e-4 (the eval tests' bound, some 20 layers), greedy tokens and the
    program-match vectors equal, node attention and the execution bitmap
    atol 1e-5;
  * one whole float32 train step per family: tests/test_torch_port_engines_train.py.

LCGN draws its initial context features at every forward. The JAX side's
draw is captured by wrapping ``jax.random.normal`` (in the module tests,
which run eagerly), or replaced by a fixed array that is baked into the
jitted steps; the port gets the same array as ``x_ctx``.
"""
import dataclasses
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvqa_tpu_torch.config as pcfg
from graphvqa_tpu.config import Config as JaxConfig
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.nn import execution as jexec
from graphvqa_tpu.nn import gnn as jgnn
from graphvqa_tpu.train import losses as jlosses
from graphvqa_tpu.train.loop import make_eval_step as jax_make_eval_step
from graphvqa_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from graphvqa_tpu_torch.models.convert import (
    from_jax_engine, from_jax_execution_engine)
from graphvqa_tpu_torch.nn import execution as pexec
from graphvqa_tpu_torch.nn import gnn as pgnn
from graphvqa_tpu_torch.train import losses
from graphvqa_tpu_torch.train.loop import make_eval_step
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_graph, port_model, port_model_config,
    random_qa_batch, tiny_model_config)

TOL = dict(rtol=1e-5, atol=1e-5)
BF16_SCALE = 5e-2
LR, WD = 1e-3, 1e-2

CFG = tiny_model_config()
C, D = CFG.scene.emb_dim, CFG.transformer.hidden_dim
R, STEPS = CFG.engine.num_rounds, CFG.max_execution_steps
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


# --- inputs ------------------------------------------------------------------

def _case(dense, dtype="float32", seed=0, widths=(C, C, D)):
    """A JAX graph batch (4 ragged graphs), its port, and numpy node, edge
    and instruction features of ``widths`` (x, edge, instruction)."""
    jb = random_qa_batch(seed=seed, num_graphs=4, cfg=CFG, dense=dense)
    g = jb.graphs
    rng = np.random.default_rng(seed + 1)
    cx, ce, ci = widths

    def arr(*shape):
        a = rng.normal(size=shape).astype(np.float32)
        return np.asarray(jnp.asarray(a, JDT[dtype]).astype(jnp.float32))

    feats = dict(x=arr(g.nodes_pad, cx), e=arr(g.edges_pad, ce),
                 ins=arr(R, g.num_graphs, ci))
    return g, port_graph(g), feats


def _j(a, dtype="float32"):
    return jnp.asarray(a, JDT[dtype])


def _t(a, dtype="float32"):
    return torch.from_numpy(np.array(a, np.float32)).to(TDT[dtype])


def _randomized(variables, seed):
    """The JAX init with random biases, BatchNorm affine and statistics (the
    init leaves them 0 and 1, which would hide a mapping fault)."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        names = [getattr(k, "key", "") for k in path]
        a = np.asarray(a)
        if names[-1] in ("bias", "scale", "mean") or names[-1].endswith(
                "_bias"):
            return (a + rng.normal(size=a.shape) * 0.3).astype(np.float32)
        if names[-1] == "var":
            return rng.uniform(0.5, 2.0, a.shape).astype(np.float32)
        return a

    return jax.tree_util.tree_map_with_path(leaf, jax.device_get(variables))


def _load(module, sd, prefix):
    module.load_state_dict({k[len(prefix):]: v for k, v in sd.items()
                            if k.startswith(prefix)})
    return module


def _close(got, want, mask=None, dtype="float32", tol=None):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    if mask is not None:
        got, want = got[mask], want[mask]
    assert np.isfinite(got).all()
    if tol is None and dtype == "bfloat16":
        scale = max(1.0, float(np.abs(want).max()))
        tol = dict(rtol=0, atol=BF16_SCALE * scale)
    np.testing.assert_allclose(got, want, **(tol or TOL))


def _bn_mode(dense):
    """Dense cases normalize with the running statistics, flat ones with
    the batch's (and update the running ones)."""
    return dense


# --- modules -----------------------------------------------------------------

def _run_seq(kind, dense, dtype):
    jg, g, f = _case(dense, dtype, seed=3)
    x, e, ins = _j(f["x"], dtype), _j(f["e"], dtype), _j(f["ins"], dtype)
    use_ra = _bn_mode(dense)
    if kind == "gcn":
        jmod = jgnn.GCNSeq(C, num_rounds=R, dtype=JDT[dtype])
        args = (jg, x, ins)
        port = pgnn.GCNSeq(C, D, R, TDT[dtype])
        pargs = (g, _t(f["x"], dtype), _t(f["ins"], dtype))
    else:
        jmod = jgnn.GINESeq(C, num_rounds=R, dtype=JDT[dtype])
        args = (jg, x, e, ins)
        port = pgnn.GINESeq(C, D, R, TDT[dtype])
        pargs = (g, _t(f["x"], dtype), _t(f["e"], dtype), _t(f["ins"], dtype))
    variables = _randomized(jmod.init(jax.random.key(0), *args), seed=4)
    want, mutated = jmod.apply(variables, *args, use_running_average=use_ra,
                               mutable=["batch_stats"])
    sd = from_jax_engine(kind, variables["params"], variables["batch_stats"])
    _load(port, sd, f"{kind}_seq.")
    got = port(*pargs, use_running_average=use_ra)
    return jg, port, got, want, mutated


@pytest.mark.parametrize("kind", ["gcn", "gine"])
@pytest.mark.parametrize("dense", [True, False], ids=["dense", "flat"])
def test_conv_seq_matches_jax_f32(kind, dense):
    jg, port, got, want, mutated = _run_seq(kind, dense, "float32")
    _close(got, want, np.asarray(jg.node_mask))
    if not _bn_mode(dense):      # batch statistics: the running ones moved
        stats = mutated["batch_stats"]
        for i, bn in enumerate(port.bns):
            _close(bn.running_mean, stats[f"bn_{i}"]["mean"])
            _close(bn.running_var, stats[f"bn_{i}"]["var"])


@pytest.mark.parametrize("kind", ["gcn", "gine"])
def test_conv_seq_matches_jax_bf16(kind):
    jg, _, got, want, _ = _run_seq(kind, True, "bfloat16")
    _close(got, want, np.asarray(jg.node_mask), dtype="bfloat16")


def test_gcn_discarded_conv_compat():
    """fix_discarded_conv=False: the released reference's dead convs (h is
    the input, normalized between rounds)."""
    jg, g, f = _case(True, seed=5)
    jmod = jgnn.GCNSeq(C, num_rounds=R, fix_discarded_conv=False)
    args = (jg, _j(f["x"]), _j(f["ins"]))
    variables = _randomized(jmod.init(jax.random.key(1), *args), seed=6)
    want = jmod.apply(variables, *args, use_running_average=True)
    port = _load(pgnn.GCNSeq(C, D, R, fix_discarded_conv=False),
                 from_jax_engine("gcn", variables["params"],
                                 variables["batch_stats"]), "gcn_seq.")
    got = port(g, _t(f["x"]), _t(f["ins"]))
    _close(got, want, np.asarray(jg.node_mask))


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "flat"])
def test_lcgn_cell_matches_jax(dense):
    H = 2                                   # the config's 1, and the mean
    jg, g, f = _case(dense, seed=7, widths=(3 * D, C, D))
    cmd = f["ins"][0]
    jmod = jgnn.LCGNCell(D, heads=H)
    variables = _randomized(jmod.init(jax.random.key(2), jg, _j(f["x"]),
                                      _j(cmd)), seed=8)
    want = jmod.apply(variables, jg, _j(f["x"]), _j(cmd))
    cell = pgnn.LCGNCell(3 * D, D, D, heads=H)
    p = variables["params"]
    sd = {f"{n}.weight": torch.from_numpy(np.asarray(p[n]["kernel"]).T.copy())
          for n in ("lin_l", "lin_r", "cal_x", "proj_cmd", "cal_cmd")}
    sd["bias"] = torch.from_numpy(np.asarray(p["bias"]))
    cell.load_state_dict(sd)
    got = cell(g, _t(f["x"]), _t(cmd))
    assert got.dtype == torch.float32
    _close(got, want, np.asarray(jg.node_mask))


def _lcgn_seq(dense, dtype, seed=9):
    """LCGNSeq on both sides; JAX's draw of x_ctx captured and handed over."""
    jg, g, f = _case(dense, dtype, seed=seed, widths=(C, C, D))
    rng = np.random.default_rng(seed)
    mem = rng.normal(size=(jg.num_graphs, 5, D)).astype(np.float32)
    mem = np.asarray(_j(mem, dtype).astype(jnp.float32))
    jmod = jgnn.LCGNSeq(D, max_iters=CFG.engine.lcgn_iters)
    args = (jg, _j(f["x"], dtype), _j(mem[:, 0], dtype), _j(mem, dtype))
    variables = _randomized(jmod.init(
        {"params": jax.random.key(3), "lcgn_ctx": jax.random.key(4)},
        *args), seed=10)
    drawn = []
    normal = jax.random.normal

    def capture(*a, **kw):
        out = normal(*a, **kw)
        drawn.append(np.asarray(out))
        return out

    with mock.patch("jax.random.normal", capture):
        want = jmod.apply(variables, *args,
                          rngs={"lcgn_ctx": jax.random.key(5)})
    assert len(drawn) == 1
    port = pgnn.LCGNSeq(C, D, D, max_iters=CFG.engine.lcgn_iters)
    _load(port, from_jax_engine("lcgn", variables["params"], {}),
          "lcgn_seq.")
    got = port(g, _t(f["x"], dtype), _t(mem[:, 0], dtype), _t(mem, dtype),
               x_ctx=torch.from_numpy(drawn[0]))
    return jg, got, want


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "flat"])
def test_lcgn_seq_matches_jax_f32(dense):
    jg, got, want = _lcgn_seq(dense, "float32")
    _close(got, want, np.asarray(jg.node_mask))


def test_lcgn_seq_computes_in_float32_under_bf16():
    """The dtype trap: the JAX cell's linear layers default to float32, so
    a bf16 question memory still gives a float32 engine, held at the
    float32 bound."""
    jg, got, want = _lcgn_seq(True, "bfloat16", seed=11)
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, np.asarray(jg.node_mask))


def test_lcgn_needs_a_generator_and_draws_from_it():
    _, g, f = _case(True, seed=12, widths=(C, C, D))
    seq = pgnn.LCGNSeq(C, D, D, max_iters=2)
    mem = torch.randn(g.num_graphs, 5, D, generator=torch.Generator()
                      .manual_seed(0))
    args = (g, _t(f["x"]), mem[:, 0], mem)
    with pytest.raises(ValueError, match="ctx_generator"):
        seq(*args)
    runs = [seq(*args, ctx_generator=torch.Generator().manual_seed(s))
            for s in (0, 0, 1)]
    state = torch.get_rng_state()
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert torch.equal(state, torch.get_rng_state())   # no global draw
    # the eval step of an lcgn model raises without its generator
    cfg = tiny_model_config("lcgn")
    model = port_model(cfg, jax_variables(cfg))
    step = make_eval_step(model, pcfg.Config(model=port_model_config(cfg)))
    batch = port_batch(random_qa_batch(seed=1, num_graphs=2, cfg=cfg,
                                       dense=True))
    with pytest.raises(ValueError, match="ctx_generator"):
        step(batch)
    step(batch, torch.Generator().manual_seed(0))


def _exec_engine(dense, dtype, seed=13):
    jg, g, f = _case(dense, dtype, seed=seed, widths=(C, C, D))
    jmod = jexec.RecurrentExecutionEngine(C, D, STEPS, JDT[dtype])
    args = (jg, _j(f["x"], dtype), _j(f["ins"], dtype))
    variables = _randomized(jmod.init(jax.random.key(6), *args), seed=14)
    want = jmod.apply(variables, *args)
    port = _load(pexec.RecurrentExecutionEngine(C, D, STEPS, TDT[dtype]),
                 from_jax_execution_engine(variables["params"]),
                 "execution_engine.")
    got = port(g, _t(f["x"], dtype), _t(f["ins"], dtype))
    return jg, got, want


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "flat"])
def test_execution_engine_matches_jax_f32(dense):
    jg, (x, bitmap, hist), (wx, wbitmap, whist) = _exec_engine(dense,
                                                               "float32")
    real = np.asarray(jg.node_mask)
    _close(x, wx, real)
    _close(bitmap, wbitmap, real)
    _close(hist, whist)


def test_execution_engine_matches_jax_bf16():
    jg, (_, bitmap, hist), (_, wbitmap, whist) = _exec_engine(
        True, "bfloat16", seed=15)
    real = np.asarray(jg.node_mask)
    _close(bitmap, wbitmap, real, dtype="bfloat16")
    _close(hist, whist, dtype="bfloat16")


@pytest.mark.parametrize("threshold", [0.3, 0.5])
def test_bitmap_precision_recall(threshold):
    rng = np.random.default_rng(16)
    pred = rng.random((40, 3)).astype(np.float32)
    true = (rng.random((40, 3)) > 0.5).astype(np.float32)
    mask = rng.random(40) > 0.2
    want = jexec.bitmap_precision_recall(_j(pred), _j(true),
                                         jnp.asarray(mask), threshold)
    got = pexec.bitmap_precision_recall(_t(pred), _t(true),
                                        torch.from_numpy(mask), threshold)
    assert [int(v) for v in got] == [int(v) for v in want]


def test_bitmap_bce_bf16_hazard_mirrors_jax():
    """A bf16 gate at or above ~0.998 clips to 1.0 (1 - 1e-7 rounds to 1 in
    bf16): -inf from log1p(-1), so NaN where the bitmap is 1 and inf where
    it is 0, in both packages alike; float32 stays finite. Each node is
    scored alone, so the positions show (in one batch, one such node makes
    the whole mean NaN, padded rows included: 0 * inf)."""
    pred = np.array([1.0, 0.999, 0.999, 0.5], np.float32)
    true = np.array([1.0, 0.0, 1.0, 0.0], np.float32)
    one = np.ones(1, bool)
    for dtype in ("bfloat16", "float32"):
        got = np.array([float(losses.bitmap_bce(
            _t(pred[r:r + 1, None], dtype), _t(true[r:r + 1, None], dtype),
            torch.from_numpy(one))) for r in range(4)])
        want = np.array([float(jlosses.bitmap_bce(
            _j(pred[r:r + 1, None], dtype), _j(true[r:r + 1, None], dtype),
            jnp.asarray(one))) for r in range(4)])
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(got[fin], want[fin],
                                   rtol=1e-2 if dtype == "bfloat16" else 1e-5)
        if dtype == "bfloat16":
            # p = 1 and p = 0.999 (1.0 in bf16): NaN with bitmap 1, inf
            # with bitmap 0; p = 0.5: finite
            assert np.isnan(got[[0, 2]]).all() and np.isposinf(got[1])
            assert np.isfinite(got[3])
        else:
            assert np.isfinite(got).all()


# --- whole steps, per family ------------------------------------------------

FAMILIES = {
    "gcn": dict(kind="gcn", program=True),
    "gine": dict(kind="gine", program=True),
    "lcgn": dict(kind="lcgn", program=True),
    "onlysg": dict(kind="none", program=False),
    "gat_exec": dict(kind="gat", program=False, exec=True),
}


def _no_dropout(cfg):
    return dataclasses.replace(
        cfg, transformer=dataclasses.replace(cfg.transformer, dropout=0.0),
        engine=dataclasses.replace(cfg.engine, dropout=0.0),
        classifier_dropout=0.0)


def _family(name):
    fam = FAMILIES[name]
    exe = fam.get("exec", False)
    cfg = _no_dropout(tiny_model_config(fam["kind"],
                                        use_execution_engine=exe))
    train = dict(lr=LR, weight_decay=WD, use_program_loss=fam["program"],
                 use_bitmap_loss=exe)
    return cfg, train


def _noise(cfg, jb):
    return np.random.default_rng(17).normal(
        size=(jb.graphs.nodes_pad, cfg.transformer.hidden_dim)
    ).astype(np.float32)


def _fixed_normal(noise):
    """``jax.random.normal`` that gives ``noise`` for LCGN's draw."""
    normal = jax.random.normal

    def draw(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    return mock.patch("jax.random.normal", draw)


def _port_with_noise(model, noise):
    if model.cfg.engine.kind == "lcgn":
        model.lcgn_seq.forward = functools.partial(
            model.lcgn_seq.forward, x_ctx=torch.from_numpy(noise))
    return model


def _eval_both(name, dense):
    cfg, _ = _family(name)
    variables = jax_variables(cfg, seed=20)
    jb = random_qa_batch(seed=21, num_graphs=4, cfg=cfg, dense=dense)
    noise = _noise(cfg, jb)
    jvars = jax.tree.map(jnp.asarray, variables)
    jmodel = JaxPipelineModel(cfg)
    with _fixed_normal(noise):
        want = jax_make_eval_step(jmodel, JaxConfig(model=cfg))(
            jax_create_train_state(jvars), jb, jax.random.key(0))
        logits = None
        if dense:
            logits = jax.jit(lambda v, b: jmodel.apply(
                v, b.replace(programs=b.programs[:, :-1],
                             full_answers=b.full_answers[:, :-1]),
                sample=True, rngs={"lcgn_ctx": jax.random.key(0)}
            ).short_answer_logits)(jvars, jb)
    model = _port_with_noise(port_model(cfg, variables), noise)
    batch = port_batch(jb)
    got = make_eval_step(model, pcfg.Config(model=port_model_config(cfg)))(
        batch, torch.Generator().manual_seed(0))
    got_logits = model.sample(batch).short_answer_logits if dense else None
    return jb, want, got, logits, got_logits


@pytest.mark.parametrize("dense", [True, False], ids=["dense", "flat"])
@pytest.mark.parametrize("name", list(FAMILIES))
def test_eval_step_matches_jax_f32(name, dense):
    jb, (wvec, wprog, watt), (vec, prog, att), wlog, glog = _eval_both(
        name, dense)
    assert set(vec) == set(wvec)
    assert ("execution_bitmap" in vec) == (name == "gat_exec")
    np.testing.assert_array_equal(prog.numpy(), np.asarray(wprog))
    for key in ("sa_pred", "program_match", "program_group_match",
                "program_empty"):
        np.testing.assert_array_equal(vec[key].numpy(), np.asarray(wvec[key]),
                                      err_msg=key)
    np.testing.assert_allclose(vec["sa_score"].numpy(),
                               np.asarray(wvec["sa_score"]), rtol=1e-4,
                               atol=1e-4)
    real = np.asarray(jb.graphs.node_mask)
    np.testing.assert_allclose(att.numpy()[real], np.asarray(watt)[real],
                               atol=1e-5)
    if "execution_bitmap" in vec:
        np.testing.assert_allclose(vec["execution_bitmap"].numpy()[real],
                                   np.asarray(wvec["execution_bitmap"])[real],
                                   atol=1e-5)
    if wlog is not None:
        np.testing.assert_allclose(glog.numpy(), np.asarray(wlog), rtol=1e-4,
                                   atol=1e-4)
