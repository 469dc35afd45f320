"""Stage-3 pretraining on the PyTorch port: high-quality instruction
tuning, iteration-based (`epochs` iterations, 1200 in the recipe), the
sources mixed by weight (`weight_sample`), the perceiver frozen and the
stage-2 adapters training on.

The command line of `main_pretrain_stage3.py` plus --device (cuda, the
default, or cpu); a checkpoint every `ckpt_period` iterations (100 unless
the config sets it), one kept; FINAL.pt and TextLoRA/ in --output at the
end. Under torchrun, --dp / --tp make a data x model mesh of the ranks
(--dist-backend nccl or gloo; README).

Run: python main_pretrain_stage3_torch.py -c Config/multi_modal_stage3.yaml \\
       --model-path out_stage2/FINAL.pt --data-path <dir>
"""

from __future__ import annotations


def main(config=None, hooks=None):
    """Train stage 3 on `config` (parsed from the command line when None),
    with `hooks` added to the trainer's; returns the trainer."""
    from lhrs_bot_tpu_torch.core import (add_train_args, parse_config,
                                         train_stage)

    if config is None:
        config = parse_config("LHRS-Bot stage-3 pretraining (PyTorch port)",
                              extra=add_train_args)
    return train_stage(config, hooks=hooks, default_ckpt_period=100)


if __name__ == "__main__":
    main()
