"""Config system: YAML files merged with CLI flags, as an attribute dict.

Counterpart of lhrs_bot_tpu/core/config.py (`ConfigDict`,
`load_yaml_config`, `ConfigArgumentParser`). `yaml` is imported only where
a file is read: the machine with the card has no guaranteed pyyaml, and the
serving path can take its config from `core.convert.eval_config()` instead.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Any, Dict, List, Optional


class ConfigDict(dict):
    """Recursive attribute-access dict. YAML-friendly, JSON-serializable."""

    def __init__(self, data: Optional[Dict[str, Any]] = None):
        super().__init__()
        for key, value in (data or {}).items():
            self[key] = value

    @staticmethod
    def _wrap(value: Any) -> Any:
        if isinstance(value, ConfigDict):
            return value
        if isinstance(value, dict):
            return ConfigDict(value)
        if isinstance(value, (list, tuple)):
            return type(value)(ConfigDict._wrap(v) for v in value)
        return value

    def __setitem__(self, key: str, value: Any) -> None:
        super().__setitem__(key, self._wrap(value))

    def __setattr__(self, key: str, value: Any) -> None:
        self[key] = value

    def __getattr__(self, key: str) -> Any:
        try:
            return self[key]
        except KeyError as exc:  # AttributeError so getattr(cfg, "x", d) works
            raise AttributeError(key) from exc

    def to_json(self, **kwargs: Any) -> str:
        return json.dumps(self, **kwargs)


def _read_yaml(path: str) -> Dict[str, Any]:
    import yaml

    with open(path, "r") as fh:
        return yaml.safe_load(fh) or {}


def load_yaml_config(path: str) -> ConfigDict:
    """A `Config/*.yaml` file as a ConfigDict (a nested dict)."""
    return ConfigDict(_read_yaml(path))


class ConfigArgumentParser(argparse.ArgumentParser):
    """argparse with a ``-c/--config`` YAML pre-parse: the YAML file is
    loaded first; CLI flags that were explicitly given override YAML
    values; YAML values override argparse defaults."""

    def __init__(self, *args: Any, **kwargs: Any):
        super().__init__(*args, **kwargs)
        self.config_parser = argparse.ArgumentParser(add_help=False)
        self.config_parser.add_argument(
            "-c", "--config", default=None, metavar="FILE",
            help="YAML config file")

    def parse_args(self, args: Optional[List[str]] = None):  # type: ignore[override]
        argv = list(sys.argv[1:]) if args is None else list(args)
        res, remaining = self.config_parser.parse_known_args(argv)
        yaml_dict = _read_yaml(res.config) if res.config is not None else {}
        namespace = super().parse_args(remaining)
        explicit = _explicitly_passed_dests(self, remaining)
        merged = ConfigDict(vars(namespace))
        for key, value in yaml_dict.items():
            if key not in explicit:
                merged[key] = value
        merged["config"] = res.config
        return merged


def _explicitly_passed_dests(parser: argparse.ArgumentParser,
                             argv: List[str]) -> set:
    """The dests the user actually typed on the command line."""
    tokens = set()
    for tok in argv:
        if tok.startswith("--"):
            tokens.add(tok.split("=", 1)[0])
        elif tok.startswith("-") and len(tok) > 1 and not tok[1].isdigit():
            tokens.add(tok.split("=", 1)[0])
    return {action.dest for action in parser._actions  # noqa: SLF001
            if any(opt in tokens for opt in action.option_strings)}
