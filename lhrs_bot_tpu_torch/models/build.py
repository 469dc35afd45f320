"""Model factory: counterpart of `lhrs_bot_tpu/models/build.py`.

`build_model(config)` gives the composed VLM's config and random
parameters (`init_vlm_params`) from a merged config dict of
`Config/*.yaml`'s schema. `core.build_model` is the loader of the released
weights.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from .vlm import VLMConfig, init_vlm_params


def build_model(config, *, generator: Optional[torch.Generator] = None,
                init_params: bool = True, dtype: torch.dtype = torch.float32,
                device="cuda") -> Tuple[VLMConfig, Optional[dict]]:
    """(VLMConfig, parameters or None). The parameters' seed is drawn
    from `generator` (seed 0 without one, as JAX's PRNGKey(0)); they are
    made in `dtype` on `device`, which defaults to the card and raises
    with none visible."""
    cfg = VLMConfig.from_config_dict(config)
    params = None
    if init_params:
        seed = 0 if generator is None else int(torch.randint(
            0, 2 ** 31 - 1, (1,), generator=generator))
        params = init_vlm_params(cfg, seed=seed, dtype=dtype, device=device)
    return cfg, params
