from .constants import IGNORE_INDEX, IMAGE_TOKEN_INDEX  # noqa: F401
from .llama import (KVCache, LlamaConfig, causal_lm_loss,  # noqa: F401
                    llama_apply, llama_decode_step, llama_prefill)
from .llama_paged import (PagedKVCache, paged_decode_step,  # noqa: F401
                          paged_prefill_with_context, scatter_prefill)
from .perceiver import (PerceiverConfig, perceiver_resample,  # noqa: F401
                        perceiver_resample_fused)
from .splice import (SplicedBatch, splice_image_embeddings,  # noqa: F401
                     splice_image_embeddings_multi)
from .vit import ViTConfig, vit_encode, vit_encode_fused  # noqa: F401
from .lora import (LoraConfig, attach_runtime_lora,  # noqa: F401
                   init_lora_params, merge_lora)
from .vlm import (VLMConfig, effective_llama_params,  # noqa: F401
                  encode_image, init_vlm_params,
                  prepare_multimodal_inputs, trainable_mask,
                  vlm_forward_loss)
