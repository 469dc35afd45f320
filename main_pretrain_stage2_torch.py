"""Stage-2 pretraining on the PyTorch port: multi-task instruction tuning
with LoRA on every decoder projection (over an int8 base with `bits: 8`).

The command line of `main_pretrain_stage2.py` plus --device (cuda, the
default, or cpu); a checkpoint every `ckpt_period` iterations (100 unless
the config sets it), one kept; FINAL.pt and TextLoRA/ in --output at the
end. Under torchrun, --dp / --tp make a data x model mesh of the ranks
(--dist-backend nccl or gloo; README).

Run: python main_pretrain_stage2_torch.py -c Config/multi_modal_stage2.yaml \\
       --model-path out_stage1/FINAL.pt --data-path <dir>
"""

from __future__ import annotations


def main(config=None, hooks=None):
    """Train stage 2 on `config` (parsed from the command line when None),
    with `hooks` added to the trainer's; returns the trainer."""
    from lhrs_bot_tpu_torch.core import (add_train_args, parse_config,
                                         train_stage)

    if config is None:
        config = parse_config("LHRS-Bot stage-2 pretraining (PyTorch port)",
                              extra=add_train_args)
    return train_stage(config, hooks=hooks, default_ckpt_period=100)


if __name__ == "__main__":
    main()
