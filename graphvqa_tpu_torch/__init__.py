"""graphvqa_tpu_torch — the PyTorch/CUDA port of graphvqa_tpu for NVIDIA Hopper.

The JAX package ``graphvqa_tpu`` stays the reference; this package mirrors its
module layout and names (``config``, ``core``, ``ops``, ``nn``, ``models``,
``train``) so every module's counterpart is easy to find. It imports torch and
numpy only, never jax, flax or graphvqa_tpu.

This slice ports the greedy-eval path of ``config.gat_config()``:

  core/    batch containers, dense packing, device selection
  ops/     dense per-graph graph ops (index ops) and the fused GAT round,
           a hand-written CUDA kernel (csrc/gat_round.cu) with its plain twin
  nn/      embeddings, transformers, masked BatchNorm, GAT engine, encoders,
           KV-cached greedy decoders, conditional pooling
  models/  PipelineModel (kind="gat", sample=True) and weight conversion
  train/   program-match metrics and make_eval_step, the serving entry point

Entry points take ``device=None`` and mean the GPU by it; without one they
raise rather than fall back to the CPU.
"""
