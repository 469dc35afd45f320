"""Data: the training and generation collators and the serving host pipeline
(conversation templates, image-token tokenization, the byte-level
tokenizer, the CLIP resize, PNG decode): jax-free copies of the JAX
package's, which need no PIL, transformers or tokenizers."""

from .collate import (GenerationCollator, PackingCollator,  # noqa: F401
                      SupervisedCollator)
