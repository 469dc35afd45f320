"""Multi-process parallelism of the port on `torch.distributed`, one
process a rank (torchrun): counterpart of `lhrs_bot_tpu/parallel`.

  * `distribute`: rank helpers, host-object all-gather, metric reduction,
    seed sync, barriers, and `init_distributed` (the backend is the
    caller's: `--dist-backend nccl|gloo`);
  * `mesh`: the ("data", "model") mesh of process groups (`make_mesh`)
    and the tensor-parallel autograd functions;
  * `partition`: the spec tables and each rank's slice of a parameter
    tree, quantized leaves sliced by logical rows and columns;
  * `zero`: the flat ZeRO-2 shard of the optimizer's slots over the data
    axis (`train.optimizer.ShardedTrainOptimizer` runs the update);
  * `context`: the ("data", "seq") mesh of context parallelism
    (`make_cp_mesh`), the sequence-split decoder and its loss, and the
    gradients' sum over the ring (`ops.ring_attention` is its attention).
"""

from .distribute import (all_gather_object, barrier,  # noqa: F401
                         get_rank, get_world_size, init_distributed,
                         is_distributed, is_main_process, reduce_dict,
                         sync_random_seed)
from .mesh import (DATA_AXIS, MODEL_AXIS, Axis, Mesh,  # noqa: F401
                   copy_to_model, gather_from_model, local_batch_size,
                   make_mesh, process_count, process_index,
                   reduce_from_model)
from .partition import (batch_specs, gather_params,  # noqa: F401
                        kv_cache_spec, llama_param_specs,
                        llama_serving_specs, shard_llama_for_serving,
                        shard_params, shard_quantized, unshard_quantized,
                        vlm_param_specs)
from .zero import FlatShard  # noqa: F401
from .context import (SEQ_AXIS, CpMesh,  # noqa: F401
                      context_parallel_apply, context_parallel_loss,
                      make_cp_mesh, reduce_gradients)
