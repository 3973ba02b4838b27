"""Convert a reference GraphVQA torch checkpoint into a checkpoint that the
port's trainer resumes (port of ``graphvqa_tpu/cli/convert_ckpt_cli.py``).

    python -m graphvqa_tpu_torch.cli.convert_ckpt_cli \
        --torch-ckpt checkpoint.pth --out outputdir/ckpt_converted

The input is the reference trainer's ``torch.save({'model': state_dict,
...})`` (a bare state dict works too; DDP's ``module.`` prefix is dropped).
The port keeps the reference's parameter names, so the state dict loads into
the port's model with a plain ``load_state_dict``, which also checks every
name and shape. The output is a checkpoint directory for ``--resume``:

    python -m graphvqa_tpu_torch.cli.train_cli --model gat --evaluate \
        --resume outputdir/ckpt_converted --output_dir outputdir ...

``--torch-vocab questions/GQA_TEXT_obj.pkl`` also imports the reference's
pickled torchtext vocabulary (no torchtext needed,
``data/torchtext_import.py``) as ``text_vocab.json`` beside the checkpoint
(the trainer's output_dir, where it looks first): the embedding rows are
indexed by that vocabulary's order. It works without ``--torch-ckpt`` too.

The model's family is ``--model`` and its depths the flags below; its
widths, vocabulary sizes and whether it has the execution engine are read
from the checkpoint's tensors. The optimizer starts fresh; ``--epoch`` seeds
the StepLR schedule (default: the checkpoint's saved epoch, else 0).
"""
from __future__ import annotations

import argparse
import dataclasses
import pathlib


def get_args_parser():
    p = argparse.ArgumentParser("GraphVQA torch checkpoint converter",
                                add_help=False)
    p.add_argument("--torch-ckpt", default="",
                   help="reference checkpoint .pth (torch.save dict with a "
                        "'model' state_dict, or a bare state_dict)")
    p.add_argument("--out", default="",
                   help="output checkpoint directory (pass to --resume)")
    p.add_argument("--torch-vocab", default="",
                   help="reference GQA_TEXT_obj.pkl (pickled torchtext "
                        "Field), imported without torchtext into "
                        "text_vocab.json")
    p.add_argument("--vocab-out", default="",
                   help="where to write text_vocab.json (default: the "
                        "parent of --out, the trainer's output_dir)")
    p.add_argument("--model", default="gat",
                   choices=["gat", "gcn", "gine", "lcgn", "onlysg"])
    p.add_argument("--num-encoder-layers", type=int, default=None,
                   help="default: the configuration's (3)")
    p.add_argument("--num-decoder-layers", type=int, default=None,
                   help="must equal --num-encoder-layers (the port builds "
                        "one depth for both)")
    p.add_argument("--num-rounds", type=int, default=None,
                   help="engine rounds (default: the configuration's, 5)")
    p.add_argument("--lcgn-iters", type=int, default=None,
                   help="LCGN iterations (default: the configuration's, 4)")
    p.add_argument("--epoch", type=int, default=None,
                   help="schedule position to record (default: the "
                        "checkpoint's saved epoch, else 0)")
    return p


def model_config(args, sd):
    """The port's ModelConfig of ``--model`` at the checkpoint's widths and
    vocabulary sizes (read from its tensors' shapes) and the flags' depths.
    The attention heads are not in any shape: they stay the
    configuration's, which the loaded tensors do not depend on."""
    from graphvqa_tpu_torch.config import CONFIG_FACTORY
    cfg = CONFIG_FACTORY[args.model]().model
    enc = args.num_encoder_layers or cfg.transformer.num_layers
    dec = args.num_decoder_layers or enc
    if enc != dec:
        raise SystemExit(f"--num-encoder-layers {enc} != --num-decoder-layers"
                         f" {dec}: the port builds one depth for both")
    text = sd["text_vocab_embedding.weight"].shape
    scene = sd["scene_graph_encoder.sg_vocab_embedding.weight"].shape
    layer = "question_encoder.transformer_encoder.layers.0."
    return dataclasses.replace(
        cfg,
        text=dataclasses.replace(cfg.text, vocab_size=text[0],
                                 emb_dim=text[1]),
        scene=dataclasses.replace(cfg.scene, vocab_size=scene[0],
                                  emb_dim=scene[1]),
        transformer=dataclasses.replace(
            cfg.transformer, num_layers=enc,
            hidden_dim=sd[layer + "norm1.weight"].shape[0],
            ffn_dim=sd[layer + "linear1.weight"].shape[0]),
        engine=dataclasses.replace(
            cfg.engine,
            num_rounds=args.num_rounds or cfg.engine.num_rounds,
            lcgn_iters=args.lcgn_iters or cfg.engine.lcgn_iters),
        classifier_hidden=sd["logit_fc.1.weight"].shape[0],
        use_execution_engine=any(k.startswith("execution_engine.")
                                 for k in sd))


def main(args):
    if not args.torch_ckpt and not args.torch_vocab:
        raise SystemExit("nothing to do: pass --torch-ckpt and/or "
                         "--torch-vocab")
    if args.torch_ckpt and not args.out:
        raise SystemExit("--torch-ckpt requires --out")

    if args.torch_vocab:
        from graphvqa_tpu_torch.data.torchtext_import import (
            import_reference_vocab)
        vocab_out = pathlib.Path(args.vocab_out) if args.vocab_out else (
            pathlib.Path(args.out).resolve().parent / "text_vocab.json")
        vocab_out.parent.mkdir(parents=True, exist_ok=True)
        glove_out = vocab_out.with_name("glove_text.npy")
        n, wrote_glove = import_reference_vocab(
            args.torch_vocab, vocab_out, glove_out)
        print(f"imported reference vocab: {n} tokens -> {vocab_out}"
              + (f" (+ aligned GloVe matrix {glove_out})" if wrote_glove
                 else " (no pretrained vectors in the pickle)"))
        if not args.torch_ckpt:
            return

    import torch

    from graphvqa_tpu_torch.models.pipeline import PipelineModel
    from graphvqa_tpu_torch.train.checkpoint import save_checkpoint
    from graphvqa_tpu_torch.train.train_state import create_train_state

    blob = torch.load(args.torch_ckpt, map_location="cpu",
                      weights_only=False)
    sd = blob.get("model", blob) if isinstance(blob, dict) else blob
    sd = {k[len("module."):] if k.startswith("module.") else k: v
          for k, v in sd.items()}
    model = PipelineModel(model_config(args, sd))
    model.load_state_dict(sd)
    n = sum(p.numel() for p in model.parameters())
    print(f"loaded {len(sd)} reference tensors: {n / 1e6:.1f}M params")

    state = create_train_state(model)
    epoch = args.epoch
    if epoch is None:
        epoch = int(blob.get("epoch", 0)) if isinstance(blob, dict) else 0
    state.epoch = epoch
    out = pathlib.Path(args.out)
    save_checkpoint(out, state)
    print(f"saved checkpoint at {out} (epoch={epoch}); evaluate with "
          f"--resume {out}")


if __name__ == "__main__":
    parser = argparse.ArgumentParser(
        "GraphVQA checkpoint converter (PyTorch)", parents=[get_args_parser()])
    main(parser.parse_args())
