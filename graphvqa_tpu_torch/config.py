"""Config tree of the port: its own copy of ``graphvqa_tpu/config.py``.

Kept: the model tree, the static batch shape and the trainer's settings
(the JAX package's mesh layout is not ported yet). Field names, defaults and
the factories of ``CONFIG_FACTORY`` match the JAX package, so a config made
for one side reads the same on the other.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class TextConfig:
    """Shared question/program/full-answer vocabulary and embedding."""
    vocab_size: int = 2933
    emb_dim: int = 300
    pad_idx: int = 1                # <unk>=0 <pad>=1 <start>=2 <end>=3
    unk_idx: int = 0
    sos_idx: int = 2
    eos_idx: int = 3


@dataclasses.dataclass(frozen=True)
class SceneGraphConfig:
    """Scene-graph vocabulary and token widths."""
    vocab_size: int = 2075
    emb_dim: int = 300
    pad_idx: int = 1
    max_obj_tokens: int = 12        # 1 name + up to 11 attributes
    max_edge_tokens: int = 1        # one relation token


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    """Question encoder / program decoder / full-answer decoder stacks."""
    hidden_dim: int = 512
    num_heads: int = 8
    ffn_dim: int = 2048
    num_layers: int = 3
    dropout: float = 0.1
    max_len: int = 80


@dataclasses.dataclass(frozen=True)
class EngineConfig:
    """Language-conditioned message-passing engine."""
    kind: str = "gat"
    num_rounds: int = 5
    heads: int = 4
    negative_slope: float = 0.2
    dropout: float = 0.1
    lcgn_iters: int = 4
    lcgn_heads: int = 1


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    text: TextConfig = dataclasses.field(default_factory=TextConfig)
    scene: SceneGraphConfig = dataclasses.field(default_factory=SceneGraphConfig)
    transformer: TransformerConfig = dataclasses.field(
        default_factory=TransformerConfig)
    engine: EngineConfig = dataclasses.field(default_factory=EngineConfig)
    num_answers: int = 1842
    max_execution_steps: int = 5
    program_decode_len: int = 16
    full_answer_decode_len: int = 20
    classifier_hidden: int = 512
    classifier_dropout: float = 0.2
    use_execution_engine: bool = False
    use_full_answer: bool = True
    # compute dtype of the transformer and engine products; parameters stay
    # float32 (the JAX package's shipping default is bfloat16 too)
    dtype: str = "bfloat16"

    def replace_engine(self, kind: str) -> "ModelConfig":
        return dataclasses.replace(
            self, engine=dataclasses.replace(self.engine, kind=kind))


@dataclasses.dataclass(frozen=True)
class BatchConfig:
    """Static padded shape of one batch (dense layout)."""
    num_graphs: int = 32
    nodes_pad: int = 1024
    edges_pad: int = 4096
    question_len: int = 32
    program_len: int = 16
    full_answer_len: int = 20
    layout: str = "dense"
    nodes_per_graph: int = 64
    edges_per_graph: int = 256


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """The trainer's settings (Adam with StepLR stepped per epoch)."""
    lr: float = 1e-4
    lr_drop: int = 90               # StepLR step size, in epochs
    lr_gamma: float = 0.1
    epochs: int = 200
    batch_size: int = 200
    weight_decay: float = 0.0
    seed: int = 1234
    print_freq: int = 100
    validate_every: int = 5
    output_dir: str = "./outputdir"
    # loss composition: the GAT configuration trains short-answer CE only
    use_program_loss: bool = False
    use_full_answer_loss: bool = False
    use_bitmap_loss: bool = False


@dataclasses.dataclass(frozen=True)
class Config:
    model: ModelConfig = dataclasses.field(default_factory=ModelConfig)
    batch: BatchConfig = dataclasses.field(default_factory=BatchConfig)
    train: TrainConfig = dataclasses.field(default_factory=TrainConfig)


def gat_config() -> Config:
    return Config()


def _baseline(kind: str) -> Config:
    """A baseline engine; the baselines train the program loss too."""
    c = Config()
    return dataclasses.replace(
        c, model=c.model.replace_engine(kind),
        train=dataclasses.replace(c.train, use_program_loss=True))


def gcn_config() -> Config:
    return _baseline("gcn")


def gine_config() -> Config:
    return _baseline("gine")


def lcgn_config() -> Config:
    return _baseline("lcgn")


def onlysg_config() -> Config:
    """The ablation: the GAT engine with the question memory zeroed."""
    c = Config()
    return dataclasses.replace(c, model=c.model.replace_engine("none"))


CONFIG_FACTORY = {
    "gat": gat_config,
    "gcn": gcn_config,
    "gine": gine_config,
    "lcgn": lcgn_config,
    "onlysg": onlysg_config,
}
