"""Multi-process helpers of the port: the host-object half of
`lhrs_bot_tpu/parallel/distribute.py` on `torch.distributed`. The mesh,
partition, ZeRO and context-parallel modules are not ported."""

from .distribute import (all_gather_object, barrier,  # noqa: F401
                         get_rank, get_world_size, init_distributed,
                         is_distributed, is_main_process, reduce_dict,
                         sync_random_seed)
