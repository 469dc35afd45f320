"""Stage-1 pretraining on the PyTorch port: caption alignment (the
perceiver trains, the vision tower and the decoder stay frozen).

The command line of `main_pretrain_stage1.py` (-c, --model-path,
--data-path, --batch-size, --workers, --output, --seed, --auto-resume,
--use-checkpoint) plus --device (cuda, the default, or cpu). A checkpoint
every `ckpt_period` iterations (1000 unless the config sets it), one kept;
FINAL.pt in --output at the end. Under torchrun, --dp / --tp make a
data x model mesh of the ranks (--dist-backend nccl or gloo; README).

Run: python main_pretrain_stage1_torch.py -c Config/multi_modal_stage1.yaml \\
       --data-path <dir> --batch-size 8 --output out_stage1
"""

from __future__ import annotations


def main(config=None, hooks=None):
    """Train stage 1 on `config` (parsed from the command line when None),
    with `hooks` added to the trainer's; returns the trainer."""
    from lhrs_bot_tpu_torch.core import (add_train_args, parse_config,
                                         train_stage)

    if config is None:
        config = parse_config("LHRS-Bot stage-1 pretraining (PyTorch port)",
                              extra=add_train_args)
    return train_stage(config, hooks=hooks, default_ckpt_period=1000)


if __name__ == "__main__":
    main()
