"""Small fixtures of the port that import no JAX, shared by the CPU parity
tests and the card tests (which run where JAX is not installed)."""
import numpy as np
import torch

from graphvqa_tpu_torch.core.packing import GraphSample, pack_graphs_dense
from graphvqa_tpu_torch.nn.gnn import GATSeq


def tiny_gat_seq(dtype, seed=0):
    """A 2-round GATSeq at narrow widths with seeded weights and BatchNorm
    statistics, and a packed batch of 3 ragged graphs plus a dummy, its
    node and edge features and instruction vectors (all on the CPU)."""
    torch.manual_seed(seed)
    C, D, R, heads = 12, 10, 2, 2
    seq = GATSeq(C, D, num_rounds=R, heads=heads, dtype=dtype).eval()
    with torch.no_grad():
        for conv in seq.convs:
            for att in (conv.att_l, conv.att_r, conv.att_e):
                att.normal_(0.0, 0.3)
            conv.bias.normal_(0.0, 0.1)
        for bn in seq.bns:
            bn.running_mean.normal_(0.0, 0.5)
            bn.running_var.uniform_(0.5, 2.0)
    rng = np.random.default_rng(seed)
    samples = []
    for n, e in ((5, 14), (9, 30), (2, 3)):
        samples.append(GraphSample(
            node_tokens=np.ones((n, 12), np.int32),
            edge_src=rng.integers(0, n, size=e).astype(np.int32),
            edge_dst=rng.integers(0, n, size=e).astype(np.int32),
            edge_tokens=np.ones((e, 1), np.int32), edge_sym=np.zeros(e, bool)))
    g = pack_graphs_dense(samples, 16, 64, num_graphs=4)
    x = torch.from_numpy(rng.normal(size=(g.nodes_pad, C)).astype(np.float32))
    e = torch.from_numpy(rng.normal(size=(g.edges_pad, C)).astype(np.float32))
    ins = torch.from_numpy(rng.normal(size=(R, 4, D)).astype(np.float32))
    return seq, g, x, e, ins


def tiny_train_case(seed=0):
    """A float32 Config at narrow widths with every dropout at 0, and a
    packed QABatch of 3 ragged graphs (on the CPU)."""
    from graphvqa_tpu_torch import config as pc
    from graphvqa_tpu_torch.core.graph import QABatch
    model = pc.ModelConfig(
        text=pc.TextConfig(vocab_size=60, emb_dim=16),
        scene=pc.SceneGraphConfig(vocab_size=40, emb_dim=12),
        transformer=pc.TransformerConfig(hidden_dim=32, num_heads=4,
                                         ffn_dim=64, num_layers=2,
                                         dropout=0.0),
        engine=pc.EngineConfig(num_rounds=3, heads=2, dropout=0.0),
        num_answers=20, max_execution_steps=3, program_decode_len=8,
        full_answer_decode_len=8, classifier_hidden=32,
        classifier_dropout=0.0, dtype="float32")
    rng = np.random.default_rng(seed)
    samples = []
    for n, e in ((5, 9), (7, 14), (3, 4)):
        samples.append(GraphSample(
            rng.integers(2, 40, (n, 12)).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(0, n, e).astype(np.int32),
            rng.integers(2, 40, (e, 1)).astype(np.int32), rng.random(e) > 0.7))
    g = pack_graphs_dense(samples, 8, 16, max_steps=3)
    t = lambda a: torch.from_numpy(a.astype(np.int32))  # noqa: E731
    batch = QABatch(g, t(rng.integers(4, 60, (3, 7))),
                    t(rng.integers(4, 60, (9, 6))),
                    t(rng.integers(4, 60, (3, 8))), t(rng.integers(0, 20, (3,))))
    return pc.Config(model=model), batch


def layer_norm_backward_closed_form(dy, x, weight, eps=1e-5):
    """The LayerNorm kernels' backward as a specification, in plain torch:
    with the statistics of the forward (float32, E[x^2] - E[x]^2),
    g = dy * weight and xhat = (x - mean) * rstd,
    dx = rstd * (g - mean(g) - xhat * mean(g * xhat)), and rstd * (g -
    mean(g)) on rows whose variance the forward clamped at 0 (v < 0: the
    clamp passes no gradient) -> (dx in x's dtype, dweight and dbias [D]
    float32, summed over the rows)."""
    d = x.shape[-1]
    xf = x.float().reshape(-1, d)
    dyf = dy.float().reshape(-1, d)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf * xf).mean(dim=-1, keepdim=True) - mean * mean
    rstd = torch.rsqrt(var.clamp(min=0) + eps)
    xhat = (xf - mean) * rstd
    g = dyf * weight
    mg = g.mean(dim=-1, keepdim=True)
    mgx = torch.where(var < 0, 0.0, (g * xhat).mean(dim=-1, keepdim=True))
    dx = rstd * (g - mg - xhat * mgx)
    return (dx.to(x.dtype).reshape(x.shape), (dyf * xhat).sum(dim=0),
            dyf.sum(dim=0))


def layer_norm_rows(kind, rows, d, seed=0):
    """float32 rows [rows, d] for the LayerNorm tests: 'random' (a per-row
    offset of about half the spread, as the stacks' residual sums have),
    'constant' (one value a row: in float32 the composite's E[x^2] - E[x]^2
    rounds below 0 on many of them, where the clamp is active; rounded to
    bfloat16 the sums are exact and the variance 0) or 'zero'."""
    gen = torch.Generator().manual_seed(seed)
    if kind == "random":
        return (torch.randn(rows, 1, generator=gen) * 0.5
                + torch.randn(rows, d, generator=gen)
                * torch.rand(rows, 1, generator=gen).mul(2).add(0.5))
    if kind == "constant":
        return (torch.randn(rows, 1, generator=gen) * 3).expand(
            rows, d).contiguous()
    if kind == "zero":
        return torch.zeros(rows, d)
    raise ValueError(kind)


# float32's unit round-off, the unit of the LayerNorm forward's readings
F32_ULP = 2.0 ** -24
# The LayerNorm kernels' forward against the plain composite
# (layer_norm_errors), in units of F32_ULP: about twice the worst readings
# of the card tests' and chip_smoke.py's cases ('random' rows, 1 to 16,000
# rows at widths 7 to 1,024, x in float32 or bfloat16; H100, the first run
# of these readings): mean 2.48, rstd 17.55, y 1.63 in bfloat16 (beyond
# one step) and 76.76 in float32. The composite's own statistics read up
# to 2.67 and 15.83 against float64. One ulp of y cannot hold: the kernel
# sums a row in another order than torch's reductions, so its mean and
# rstd differ from the composite's by a few float32 ulps, and y = (x -
# mean) * rstd * w + b carries that to every element of the row, many ulps
# of y where x lies near the mean.
LAYER_NORM_ULPS = {"mean": 5.0, "rstd": 36.0, "y.bfloat16": 4.0,
                   "y.float32": 160.0}


def layer_norm_stats(x, eps=1e-5):
    """[rows, 2] float32 (mean, rstd) as the composite computes them."""
    xf = x.float().reshape(-1, x.shape[-1])
    mean = xf.mean(dim=-1)
    var = (xf * xf).mean(dim=-1) - mean * mean
    return torch.stack([mean, torch.rsqrt(var.clamp(min=0) + eps)], dim=1)


def layer_norm_errors(x, weight, bias, stats, y, y_ref, eps=1e-5):
    """The worst errors of a LayerNorm forward, in units of F32_ULP:
    (mean, rstd, y). ``stats`` [rows, 2] (mean, rstd; the kernel's rstd
    may carry its clamp sign) against float64 statistics of x by the same
    formula, the mean relative to its row's mean |x| and rstd relative to
    itself; ``y`` against the composite's ``y_ref`` beyond one output step
    where y is bfloat16 (two values within it may round a step apart),
    relative to its terms (|x - mean| + |mean|) * rstd * |w| + |b|."""
    d = x.shape[-1]
    x64 = x.double().reshape(-1, d)
    mean64 = x64.mean(dim=-1)
    var64 = (x64 * x64).mean(dim=-1) - mean64 * mean64
    rstd64 = torch.rsqrt(var64.clamp(min=0) + eps)
    mean, rstd = stats[:, 0].double(), stats[:, 1].double().abs()

    def worst(err, scale):
        ratio = torch.where(err == 0, torch.zeros_like(err),
                            err / (scale * F32_ULP))
        return float(ratio.max())

    xf = x.float().reshape(-1, d)
    terms = (((xf - stats[:, :1]).abs() + stats[:, :1].abs())
             * stats[:, 1:].abs() * weight.abs() + bias.abs())
    diff = (y.float() - y_ref.float()).abs().reshape(-1, d)
    if y.dtype == torch.bfloat16:
        big = torch.maximum(y.float().abs(), y_ref.float().abs())
        _, exp = torch.frexp(big.reshape(-1, d))
        diff = (diff - torch.ldexp(torch.ones_like(diff), exp - 8)).clamp(
            min=0)
    return (worst((mean - mean64).abs(), x64.abs().mean(dim=-1)),
            worst((rstd - rstd64).abs(), rstd64),
            worst(diff.double(), terms.double()))


def scene_law_mask(B, npg, seed):
    """node_mask [B * npg] bool of B graphs whose sizes follow the benchmark
    traffic's scene law (``int(lognormvariate(2.7, 0.55)) + 2`` objects, cut
    at npg), each graph's real rows first in its block, as the packer puts
    them."""
    import random
    rng = random.Random(seed)
    sizes = torch.tensor([min(npg, int(rng.lognormvariate(2.7, 0.55)) + 2)
                          for _ in range(B)])
    return (torch.arange(npg)[None, :] < sizes[:, None]).reshape(-1)


def round_off_share(got, want, n, scale):
    """The largest |got - want| as a share of 2 n 2^-24 scale, element by
    element: each of two float32 sums of n products, taken in different
    orders, lies within n u sum|terms| of the exact sum (u = 2^-24, the
    float32 unit round-off), and ``scale`` is sum|terms|. At most 1 where
    both are float32 sums of the same terms."""
    bound = 2 * n * 2.0 ** -24 * scale + 1e-30
    return float(((got - want).abs() / bound).max())
