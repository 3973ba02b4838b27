"""graphvqa_tpu_torch — the PyTorch/CUDA port of graphvqa_tpu for NVIDIA Hopper.

The JAX package ``graphvqa_tpu`` stays the reference; this package mirrors its
module layout and names (``config``, ``core``, ``ops``, ``nn``, ``models``,
``train``) so every module's counterpart is easy to find. It imports torch and
numpy only, never jax, flax or graphvqa_tpu.

Ported so far: the greedy-eval path and the train step of
``config.gat_config()``:

  core/    batch containers, dense packing, device selection
  ops/     dense per-graph graph ops (index ops) and the fused GAT round,
           hand-written CUDA kernels for its forward (csrc/gat_round.cu) and
           backward (csrc/gat_round_backward.cu), each with its plain twin
  nn/      embeddings, transformers with dropout, masked BatchNorm, GAT
           engine, encoders, teacher-forced and KV-cached greedy decoders,
           conditional pooling
  models/  PipelineModel (kind="gat": forward and sample) and weight
           conversion
  train/   losses, metrics, Adam with StepLR, checkpoints, meters,
           make_train_step and train_one_epoch, and make_eval_step, the
           serving entry point

Entry points take ``device=None`` and mean the GPU by it; without one they
raise rather than fall back to the CPU.
"""
