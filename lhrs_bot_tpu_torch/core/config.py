"""YAML config loading (counterpart of lhrs_bot_tpu/core/config.py).

`yaml` is imported inside the loader only: the machine with the card has no
guaranteed pyyaml, and the serving path takes its config from
`core.convert.eval_config()` instead.
"""

from __future__ import annotations


def load_yaml_config(path: str) -> dict:
    """A `Config/*.yaml` file as a plain nested dict."""
    import yaml

    with open(path, "r") as fh:
        return yaml.safe_load(fh) or {}
