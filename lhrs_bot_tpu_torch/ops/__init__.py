"""Compute primitives. Plain torch ops, plus the hand-written CUDA kernels'
entry points (`flash_attention`, `fused_decode_attention`,
`fused_decode_attention_q`, `cache_row_update`, `paged_fused_decode`,
`paged_fused_decode_q`, `w4a8_matmul_stacked` through `w4a8_project`,
`ln_quant.ln_quant` (under `quantize_activation`), `int8_gemm.int8_gemm`
(under `w8a8_matmul`, and `dense_any` and `gelu_mlp` with int8 weights), and
the fused W8A8 vision blocks composed of them), which take the plain version
for CPU tensors and the kernel for CUDA tensors."""

from .attention import flash_attention, mha_reference  # noqa: F401
from .cache_update import cache_row_update  # noqa: F401
from .decode_attention import decode_attention as decode_attention_op  # noqa: F401,E501
from .fused_decode import (fused_decode_attention,  # noqa: F401
                           fused_decode_attention_q)
from .mlp import dense_any, gelu_mlp, silu_mlp  # noqa: F401
from .paged_fused import (paged_fused_decode,  # noqa: F401
                          paged_fused_decode_q)
from .patch_embed import patch_embed as patch_embed_op  # noqa: F401
from .rmsnorm import layer_norm, rms_norm  # noqa: F401
from .rope import apply_rope, rope_cos_sin  # noqa: F401
from .perceiver_block import (fused_perceiver_block,  # noqa: F401
                              pack_perceiver_layers_fused)
from .quant import (QuantizedTensor, quantize_activation,  # noqa: F401
                    quantize_vision_layers, quantized_matmul, w8a8_matmul)
from .vit_block import (fused_vit_block, fused_vit_post,  # noqa: F401
                        fused_vit_qkv, pack_vit_layers_fused)
from .w4_matmul import w4a8_matmul_stacked, w4a8_project  # noqa: F401
