"""Plain PyTorch GraphVQA on the padded dense layout: the benchmark's
reference for what the program computes. The engine between the encoders
and the classifier is the configuration's ``engine.kind``, from its file
``engines/<kind>.py``.

Written from the published architecture (GraphVQA, Liang et al., NAACL 2021
MAI workshop; reference code codexxxl/GraphVQA) in float32 with TF32 off,
and from nothing of the program: the parameters are a name -> tensor dict
under the reference checkpoint's names, and every product goes through
:meth:`Reference.mm`, which rounds its operands to the precision asked for
(``"f32"`` computes exactly; ``"fp8"`` rounds each operand and each result
of a product, and each activation a bfloat16 model stores, to float8 e4m3
with one scale per tensor: the control of a bfloat16 configuration;
``"bf16"`` rounds the same to bfloat16: what the configuration's own
precision alone gives against float32).

Semantics kept from the published model and its JAX re-implementation,
which the program follows:
  * post-LN transformer stacks without padding masks; dropout on the
    attention weights, on each sublayer's output before its residual add,
    after the feed-forward ReLU and after the positional encoding;
  * the program decoder's fine stage decodes the M instruction streams, the
    instruction vector standing at position 0 of each; in training the M
    streams of a question run as one sequence under a block-causal mask;
  * a padding token embeds to zero; scene tokens are summed per node.

Dropout draws come from the generator handed in, one ``torch.rand`` per
dropout site of the shape the site's tensor has, in the order the model
runs them: the same generator state gives the masks the program draws.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

import engines

NEG = -1e30
EPS16 = 1e-16
PAD, SOS = 1, 2
FP8_MAX = 448.0
B1, B2, ADAM_EPS = 0.9, 0.999, 1e-8


def set_exact_float32() -> None:
    """No TF32 anywhere: float32 products stay float32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(t: torch.Tensor) -> torch.Tensor:
    scale = t.detach().abs().amax().clamp(min=1e-30) / FP8_MAX
    q = (t.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return t + (q - t.detach())         # rounded forward, identity backward


def _bf16(t: torch.Tensor) -> torch.Tensor:
    q = t.detach().to(torch.bfloat16).float()
    return t + (q - t.detach())         # rounded forward, identity backward


ROUND = {"fp8": _fp8, "bf16": _bf16}


def _gather(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x [B, n, ...] rows at idx [B, e] -> [B, e, ...]."""
    shape = idx.shape + x.shape[2:]
    flat = idx.reshape(idx.shape[0], -1, *([1] * (x.dim() - 2)))
    return torch.gather(x, 1, flat.expand(shape))


def _scatter_sum(v: torch.Tensor, idx: torch.Tensor, n: int) -> torch.Tensor:
    """v [B, e, ...] summed into rows idx [B, e] of [B, n, ...]."""
    out = v.new_zeros((v.shape[0], n) + v.shape[2:])
    ix = idx.reshape(idx.shape + (1,) * (v.dim() - 2)).expand(v.shape)
    return out.scatter_add(1, ix, v)


class Reference:
    def __init__(self, params: dict, model_cfg: dict, precision: str = "f32"):
        self.P, self.cfg, self.precision = params, model_cfg, precision
        t = model_cfg["transformer"]
        self.D, self.heads = t["hidden_dim"], t["num_heads"]
        self.rate = t["dropout"]
        self.engine = engines.load(model_cfg["engine"]["kind"])
        self.M = model_cfg["max_execution_steps"]
        self.cls_rate = model_cfg["classifier_dropout"]

    # -- products and small blocks ---------------------------------------
    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b``; in float8 or bfloat16 its operands and its result are
        rounded, as such a model stores what its products read and write."""
        r = ROUND.get(self.precision)
        if r is not None:
            return r(torch.matmul(r(a), r(b)))
        return torch.matmul(a, b)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """An activation as the precision stores it: rounded, where a
        bfloat16 model stores it in bfloat16."""
        r = ROUND.get(self.precision)
        return x if r is None else r(x)

    def lin(self, x, name, bias=True):
        y = self.mm(x, self.P[name + ".weight"].t())
        return y + self.P[name + ".bias"] if bias else y

    def mlp2(self, x, name):
        return self.lin(torch.relu(self.lin(x, name + ".0")), name + ".2")

    @staticmethod
    def drop(x, rate, gen):
        if gen is None or rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=gen, device=x.device) >= rate
        return torch.where(keep, x / (1.0 - rate), 0.0)

    def ln(self, x, name):
        return self.act(F.layer_norm(self.act(x), x.shape[-1:],
                                     self.P[name + ".weight"],
                                     self.P[name + ".bias"], 1e-5))

    def embed(self, ids, name):
        return self.P[name][ids] * (ids != PAD)[..., None].float()

    @staticmethod
    def pe(length, d, device):
        pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
        div = torch.exp(torch.arange(0, d, 2, dtype=torch.float32,
                                     device=device) * (-math.log(10000.0) / d))
        table = torch.zeros(length, d, device=device)
        table[:, 0::2] = torch.sin(pos * div)
        table[:, 1::2] = torch.cos(pos * div)
        return table

    # -- transformer ------------------------------------------------------
    def mha(self, xq, xkv, name, mask, gen):
        D, h = self.D, self.heads
        hd = D // h
        W, b = self.P[name + ".in_proj_weight"], self.P[name + ".in_proj_bias"]
        q = self.mm(xq, W[:D].t()) + b[:D]
        k = self.mm(xkv, W[D:2 * D].t()) + b[D:2 * D]
        v = self.mm(xkv, W[2 * D:].t()) + b[2 * D:]

        def split(t):
            return t.reshape(t.shape[0], t.shape[1], h, hd).transpose(1, 2)
        q, k, v = split(q), split(k), split(v)
        scores = self.mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
        if mask is not None:
            scores = scores + mask
        w = self.drop(torch.softmax(scores, dim=-1), self.rate, gen)
        out = self.mm(w, v).transpose(1, 2).reshape(xq.shape[0], -1, D)
        return self.lin(out, name + ".out_proj")

    def ffn(self, x, name, gen):
        hid = self.drop(torch.relu(self.lin(x, name + ".linear1")),
                        self.rate, gen)
        return self.lin(hid, name + ".linear2")

    def encoder(self, x, name, gen):
        for i in range(self.cfg["transformer"]["num_layers"]):
            ly = f"{name}.layers.{i}"
            a = self.mha(x, x, ly + ".self_attn", None, gen)
            x = self.ln(x + self.drop(a, self.rate, gen), ly + ".norm1")
            f = self.ffn(x, ly, gen)
            x = self.ln(x + self.drop(f, self.rate, gen), ly + ".norm2")
        return self.ln(x, name + ".norm")

    def decoder(self, x, memory, name, mask, gen):
        for i in range(self.cfg["transformer"]["num_layers"]):
            ly = f"{name}.layers.{i}"
            a = self.mha(x, x, ly + ".self_attn", mask, gen)
            x = self.ln(x + self.drop(a, self.rate, gen), ly + ".norm1")
            c = self.mha(x, memory, ly + ".multihead_attn", None, gen)
            x = self.ln(x + self.drop(c, self.rate, gen), ly + ".norm2")
            f = self.ffn(x, ly, gen)
            x = self.ln(x + self.drop(f, self.rate, gen), ly + ".norm3")
        return self.ln(x, name + ".norm")

    def embed_stream(self, tokens, name, gen):
        """A token stream [R, L] -> [R, L, D]: projection times sqrt(D),
        positions, dropout."""
        x = self.lin(self.embed(tokens, "text_vocab_embedding.weight"),
                     name + ".emb_proj") * math.sqrt(self.D)
        return self.drop(x + self.pe(tokens.shape[1], self.D, x.device),
                         self.rate, gen)

    @staticmethod
    def causal(length, device):
        return torch.triu(torch.full((length, length), float("-inf"),
                                     device=device), diagonal=1)

    # -- the pipeline -----------------------------------------------------
    def scene_encoder(self, b):
        n = "scene_graph_encoder"
        tab = f"{n}.sg_vocab_embedding.weight"
        nmask = b["node_mask"][..., None].float()
        emask = b["edge_mask"][..., None].float()
        x = self.act(self.embed(b["node_tokens"], tab).sum(2) * nmask)
        e = self.act(self.embed(b["edge_tokens"], tab)
                     * b["edge_sign"][..., None])
        e = e * emask
        meta = f"{n}.scene_graph_encoding_layer"
        x_src = _gather(x, b["src"]) * emask
        x_dst = _gather(x, b["dst"]) * emask
        e_out = self.mlp2(torch.cat([x_src, x_dst, e], -1),
                          meta + ".edge_model.edge_mlp") * emask
        msg = self.mlp2(torch.cat([x_src, e_out], -1),
                        meta + ".node_model.node_mlp_1") * emask
        npg = x.shape[1]
        count = _scatter_sum(emask, b["dst"], npg).clamp(min=1.0)
        aggr = _scatter_sum(msg, b["dst"], npg) / count
        x = self.mlp2(torch.cat([x, aggr], -1),
                      meta + ".node_model.node_mlp_2") * nmask
        # per-graph LayerNorm over nodes x channels, scalar affine, eps on
        # the standard deviation
        cnt = nmask.sum((1, 2), keepdim=True).clamp(min=1.0) * x.shape[-1]
        mean = x.sum((1, 2), keepdim=True) / cnt
        cen = (x - mean) * nmask
        std = ((cen * cen).sum((1, 2), keepdim=True) / cnt).sqrt()
        x = cen / (std + 1e-5) * self.P[f"{n}.graph_layer_norm.weight"] \
            + self.P[f"{n}.graph_layer_norm.bias"]
        return x * nmask, e_out

    def question_encoder(self, questions, gen):
        x = self.embed_stream(questions, "question_encoder", gen)
        return self.encoder(x, "question_encoder.transformer_encoder", gen)

    def instructions(self, memory, gen):
        """The coarse stage: [B, M, D]."""
        B = memory.shape[0]
        q = self.P["program_decoder.query_embed.weight"][None].expand(
            B, self.M, self.D)
        return self.decoder(q, memory, "program_decoder.coarse_decoder",
                            None, gen)

    def program_logits(self, memory, instr, tokens, gen, packed: bool):
        """Logits [B*M, L, V] of the fine stage over input streams
        ``tokens`` [B*M, L], position 0 being the instruction vector."""
        B, M, D = instr.shape
        x = self.embed_stream(tokens, "program_decoder", gen)
        x = torch.cat([instr.reshape(B * M, 1, D), x[:, 1:]], 1)
        L = x.shape[1]
        name = "program_decoder.transformer_decoder"
        if packed:
            blk = torch.block_diag(*[torch.ones(L, L, device=x.device).tril()]
                                   * M)
            mask = torch.where(blk > 0, 0.0, float("-inf"))
            out = self.decoder(x.reshape(B, M * L, D), memory, name, mask,
                               gen).reshape(B * M, L, D)
        else:
            out = self.decoder(x, memory.repeat_interleave(M, 0), name,
                               self.causal(L, x.device), gen)
        return self.lin(out, "program_decoder.vocab_decoder")

    def full_answer_logits(self, memory, tokens):
        x = self.embed_stream(tokens, "full_answer_decoder", None)
        out = self.decoder(x, memory, "full_answer_decoder.transformer_decoder",
                           self.causal(tokens.shape[1], x.device), None)
        return self.lin(out, "full_answer_decoder.vocab_decoder")

    def softmax_in_edges(self, lg, b, npg):
        """Softmax of logits [B, e, H] over each destination's real
        in-edges, shifted by the graph's largest logit per head."""
        em = b["edge_mask"][..., None]
        lg = torch.where(em, lg, NEG)
        gmax = lg.detach().amax(1, keepdim=True)
        p = torch.where(em, torch.exp(torch.minimum(
            lg - gmax, torch.zeros_like(lg))), 0.0)
        den = _scatter_sum(p, b["dst"], npg)
        return p / (_gather(den, b["dst"]) + EPS16)

    def batch_norm(self, h, name, nmask, train):
        if train:
            cnt = nmask.sum().clamp(min=1.0)
            mean = (h * nmask).sum((0, 1)) / cnt
            var = ((h - mean) ** 2 * nmask).sum((0, 1)) / cnt
        else:
            mean, var = (self.P[name + ".running_mean"],
                         self.P[name + ".running_var"])
        out = (h - mean) * torch.rsqrt(var + 1e-5) * self.P[name + ".weight"] \
            + self.P[name + ".bias"]
        return self.act(out * nmask)

    def classify(self, h, memory, b, gen):
        q = memory[:, 0]
        nmask = b["node_mask"][..., None]
        xn = self.mlp2(h, "graph_global_attention_pooling.node_nn")
        uq = self.mlp2(q, "graph_global_attention_pooling.ques_nn")
        gate = self.mlp2(uq[:, None] * xn,
                         "graph_global_attention_pooling.gate_nn")
        gate = torch.where(nmask, gate, NEG)
        gate = torch.exp(gate - gate.detach().amax(1, keepdim=True))
        gate = torch.where(nmask, gate, 0.0)
        gate = self.act(gate / (gate.sum(1, keepdim=True) + EPS16))
        g = (gate * xn).sum(1)
        fused = self.drop(self.act(torch.cat([g, q, g * q], -1)),
                          self.cls_rate, gen)
        hid = self.drop(F.elu(self.lin(fused, "logit_fc.1")), self.cls_rate,
                        gen)
        return self.lin(hid, "logit_fc.4")

    def train_loss(self, b, gen, ctx_gen, program_loss: bool):
        """The teacher-forced forward and the loss of one train step."""
        x, e = self.scene_encoder(b)
        memory = self.question_encoder(b["questions"], gen)
        instr = self.instructions(memory, gen)
        prog = self.program_logits(memory, instr, b["programs"][:, :-1], gen,
                                   packed=True)
        h = self.engine.forward(self, x, e, memory, instr, b, gen, ctx_gen,
                                True)
        logits = self.classify(h, memory, b, gen)
        n = b.get("rows", logits.shape[0])   # fewer rows: a planted fault
        loss = F.cross_entropy(logits[:n], b["labels"][:n])
        if program_loss:
            tgt = b["programs"][:, 1:]
            logp = torch.log_softmax(prog, -1)
            picked = -logp.gather(-1, tgt[..., None])[..., 0]
            m = (tgt != PAD).float()
            loss = loss + (picked * m).sum() / m.sum().clamp(min=1.0)
        return loss

    @torch.no_grad()
    def served_logits(self, b, program_tokens, full_answer_tokens, ctx_gen):
        """Short-answer logits [B, A] and, teacher-forced over the served
        greedy tokens, the logits of every served program token [B*M, T-1,
        V] and full-answer token [B, T-1, V]."""
        x, e = self.scene_encoder(b)
        memory = self.question_encoder(b["questions"], None)
        instr = self.instructions(memory, None)
        h = self.engine.forward(self, x, e, memory, instr, b, None, ctx_gen,
                                False)
        sa = self.classify(h, memory, b, None)
        prog = self.program_logits(memory, instr, program_tokens[:, :-1],
                                   None, packed=False)
        fa = (None if full_answer_tokens is None else
              self.full_answer_logits(memory, full_answer_tokens[:, :-1]))
        return sa, prog, fa


def adam_step(params: dict, grads: dict, mu: dict, nu: dict, count: int,
              lr: float) -> None:
    """Adam (b1 0.9, b2 0.999, eps 1e-8, bias corrected) on every leaf, a
    leaf without gradient taking a zero one."""
    with torch.no_grad():
        for n, p in params.items():
            g = grads.get(n)
            g = torch.zeros_like(p) if g is None else g
            mu[n].mul_(B1).add_(g, alpha=1.0 - B1)
            nu[n].mul_(B2).addcmul_(g, g, value=1.0 - B2)
            m_hat = mu[n] / (1.0 - B1 ** count)
            v_hat = nu[n] / (1.0 - B2 ** count)
            p.sub_(lr * m_hat / (v_hat.sqrt() + ADAM_EPS))
