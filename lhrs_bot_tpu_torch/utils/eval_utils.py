"""Generation stopping for `GenerationEngine.stream`'s `stop_fn`, and the
table of config dtype names.

Counterpart of `lhrs_bot_tpu/utils/eval_utils.py`: `KeywordsStopper` stops
once a keyword appears in the decoded tail of the emitted ids,
`make_token_stopper` once the last emitted id is a stop id. `type_dict`
maps a config's dtype name to the torch dtype the port computes in
(`core.dtypes.resolve_dtype`: float16 configs run in bf16, as in the JAX
package).
"""

from __future__ import annotations

from typing import Callable, List, Sequence

from ..core.dtypes import resolve_dtype

type_dict = {name: resolve_dtype(name)
             for name in ("float16", "bfloat16", "float32")}


class KeywordsStopper:
    """stop_fn: True once any keyword appears in the decoded last 12
    emitted ids (a bounded tail, so each step's check costs the same)."""

    def __init__(self, tokenizer, keywords: Sequence[str]):
        self.tokenizer = tokenizer
        self.keywords = list(keywords)

    def __call__(self, emitted_ids: List[int]) -> bool:
        text = self.tokenizer.decode(emitted_ids[-12:])
        return any(kw in text for kw in self.keywords)


def make_token_stopper(stop_ids: Sequence[int]
                       ) -> Callable[[List[int]], bool]:
    """stop_fn: True once the last emitted id is one of `stop_ids`."""
    stop_set = set(int(i) for i in stop_ids)

    def stop(emitted_ids: List[int]) -> bool:
        return bool(emitted_ids) and emitted_ids[-1] in stop_set

    return stop
