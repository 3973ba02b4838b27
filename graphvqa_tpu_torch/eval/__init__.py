"""The official GQA scorer of the port:
``python -m graphvqa_tpu_torch.eval.scorer``."""
