"""One whole float32 train step of each engine family (gcn, gine, lcgn,
onlysg, and gat with the execution engine) against the JAX package's
``make_train_step``, on the CPU, dropout off, in the dense and the flat
layout. The batch, weights and
LCGN's fixed context features are those of ``tests/test_torch_port_engines.py``
(whose docstring states the bounds, the train tests' own): loss, its parts
and the metrics rtol 1e-5; every gradient within 1e-5 of its tensor's
largest |gradient| plus 5e-8; updated parameters 1e-6 where |gradient| >
1e-6; BatchNorm running statistics rtol/atol 1e-5. JAX's gradients are read
back from Adam's first moment after its one step (mu = 0.1 g, within an ulp
of g), so one JAX compile per family serves every check.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import graphvqa_tpu_torch.config as pcfg
from graphvqa_tpu.config import Config as JaxConfig
from graphvqa_tpu.config import TrainConfig as JaxTrainConfig
from graphvqa_tpu.models import PipelineModel as JaxPipelineModel
from graphvqa_tpu.train.loop import make_train_step as jax_make_train_step
from graphvqa_tpu.train.train_state import (
    create_train_state as jax_create_train_state)
from graphvqa_tpu_torch.models.convert import from_jax_variables
from graphvqa_tpu_torch.train.loop import make_train_step
from graphvqa_tpu_torch.train.train_state import create_train_state
from tests.test_torch_port_engines import (
    FAMILIES, LR, TOL, WD, _family, _fixed_normal, _noise, _port_with_noise)
from tests.torch_port_helpers import (
    jax_variables, port_batch, port_model, port_model_config,
    random_qa_batch)


def _adam_grads(state):
    """The gradient of JAX's one Adam step: its first moment over 0.1."""
    adam = next(s for s in state.opt_state if hasattr(s, "mu"))
    return jax.tree.map(lambda m: np.asarray(m) / np.float32(0.1), adam.mu)


@pytest.fixture(scope="module", params=[
    (name, layout) for name in FAMILIES for layout in ("dense", "flat")],
    ids=lambda p: "-".join(p))
def train_case(request):
    name, layout = request.param
    cfg, train = _family(name)
    variables = jax_variables(cfg, seed=22)
    jb = random_qa_batch(seed=23, num_graphs=4, cfg=cfg,
                         dense=layout == "dense")
    noise = _noise(cfg, jb)
    jvars = jax.tree.map(jnp.asarray, variables)
    with _fixed_normal(noise):
        new, jm = jax_make_train_step(JaxPipelineModel(cfg), JaxConfig(
            model=cfg, train=JaxTrainConfig(**train)))(
            jax_create_train_state(jvars, lr=LR, weight_decay=WD), jb,
            jax.random.key(0))
    kind = cfg.engine.kind
    to_port = lambda params, stats: from_jax_variables(  # noqa: E731
        {"params": jax.device_get(params),
         "batch_stats": jax.device_get(stats)}, kind)
    model = _port_with_noise(port_model(cfg, variables), noise)
    state = create_train_state(model, lr=LR, weight_decay=WD)
    step = make_train_step(model, pcfg.Config(
        model=port_model_config(cfg), train=pcfg.TrainConfig(**train)))
    _, m = step(state, port_batch(jb), torch.Generator().manual_seed(0),
                torch.Generator().manual_seed(1))
    return dict(name=name, model=model, metrics=m, want_metrics=jm,
                want_grads=to_port(_adam_grads(new), variables["batch_stats"]),
                want_state=to_port(new.params, new.batch_stats))


def test_train_step_loss_parts_and_metrics_f32(train_case):
    got, want = train_case["metrics"], train_case["want_metrics"]
    assert set(got) == set(want)
    name = train_case["name"]
    assert ("program" in got) == FAMILIES[name]["program"]
    assert ("execution_bitmap" in got) == (name == "gat_exec")
    assert ("bitmap_tp" in got) == (name == "gat_exec")
    for k in want:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-5,
                                   err_msg=k)


def test_train_step_gradients_f32(train_case):
    want = train_case["want_grads"]
    params = dict(train_case["model"].named_parameters())
    assert set(params) == {k for k in want if k in params}
    for name, p in params.items():
        w = want[name].numpy()
        g = (torch.zeros_like(p) if p.grad is None else p.grad).numpy()
        np.testing.assert_allclose(g, w, rtol=1e-5,
                                   atol=1e-5 * np.abs(w).max() + 5e-8,
                                   err_msg=name)


def test_train_step_updated_params_and_running_stats_f32(train_case):
    want, model = train_case["want_state"], train_case["model"]
    grads = train_case["want_grads"]
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
