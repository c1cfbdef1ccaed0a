"""A command-line builder driven by a config dataclass: declare the dataclass
and a class to call with it, and get an entry point with ``--config-file``
(a YAML merged over the defaults) and one ``--field-name`` override per
field.

The port's own copy of ``ml_mdm_tpu/core.py`` (itself the counterpart of
the reference's ``ml_mdm/core.py``); it needs neither ``simple_parsing`` nor
anything of the JAX package.
"""
from __future__ import annotations

import argparse
import dataclasses
from dataclasses import dataclass, is_dataclass
from typing import Any, Optional, Type


@dataclass
class MDMConfig:
    pass


class ConfigPrinter:
    def __init__(self, config) -> None:
        print(config)


_TYPE_NAMES = {"int": int, "float": float, "bool": bool, "str": str}


def _parse_value(ftype, raw: str):
    """``raw`` as the field's type. Under ``from __future__ import
    annotations`` a dataclass field's type is a string: the common ones are
    resolved by name, any other stays a string."""
    if isinstance(ftype, str):
        ftype = _TYPE_NAMES.get(ftype, str)
    if ftype in (int, float):
        return ftype(raw)
    if ftype is bool:
        return raw.lower() in ("1", "true", "yes")
    return raw


@dataclass
class CLIBuilder:
    class_to_call: Type[Any] = ConfigPrinter
    config_class: Type[Any] = MDMConfig
    default_config: Optional[Any] = None

    def build_config(self, args=None):
        """The config: ``default_config`` (or the dataclass's defaults),
        then the ``--config-file`` YAML, then the command-line fields."""
        assert is_dataclass(self.config_class)
        parser = argparse.ArgumentParser()
        parser.add_argument("--config-file", type=str, default=None)
        for f in dataclasses.fields(self.config_class):
            parser.add_argument(f"--{f.name.replace('_', '-')}", dest=f.name,
                                default=argparse.SUPPRESS)
        ns = parser.parse_args(args)

        values = dataclasses.asdict(self.default_config) if self.default_config is not None else {}
        if ns.config_file:
            import yaml

            with open(ns.config_file) as fh:
                values.update(yaml.safe_load(fh) or {})
        fields_by_name = {f.name: f for f in dataclasses.fields(self.config_class)}
        for name, raw in vars(ns).items():
            if name == "config_file" or name not in fields_by_name:
                continue
            values[name] = (_parse_value(fields_by_name[name].type, raw)
                            if isinstance(raw, str) else raw)
        return self.config_class(**{k: v for k, v in values.items() if k in fields_by_name})

    def run(self, args=None):
        return self.class_to_call(self.build_config(args))
