"""Layered YAML config system with ``_BASE_`` inheritance.

TPU-native rebuild of the reference's fvcore-style CfgNode
(``captioning/utils/config.py:35-150``), written from scratch
without the yacs dependency.  Semantics preserved:

* ``load_yaml_with_base(filename)`` recursively loads ``_BASE_`` parents
  (paths relative to the child file) and overlays the child on top.
* ``merge_from_list([k, v, k, v, ...])`` parses values with a safe literal
  decoder and sets them, mirroring yacs' ``merge_from_list``.
* Attribute access works both ways (``cfg.key`` and ``cfg['key']``).
"""

from __future__ import annotations

import ast
import os
from typing import Any, Dict, List

BASE_KEY = "_BASE_"


def _decode_value(value: str) -> Any:
    """Decode a CLI string into a python literal when possible.

    Mirrors yacs' ``_decode_cfg_value``: try ``ast.literal_eval``; fall back
    to the raw string.
    """
    if not isinstance(value, str):
        return value
    try:
        return ast.literal_eval(value)
    except (ValueError, SyntaxError):
        return value


class CfgNode(dict):
    """A dict with attribute access and ``_BASE_`` YAML inheritance."""

    def __init__(self, init_dict: Dict[str, Any] | None = None):
        super().__init__()
        init_dict = init_dict or {}
        for k, v in init_dict.items():
            self[k] = CfgNode(v) if isinstance(v, dict) else v

    # -- attribute <-> item access ------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:  # pragma: no cover - mirrors dict semantics
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        del self[name]

    # -- loading -------------------------------------------------------
    @staticmethod
    def load_yaml_with_base(filename: str) -> Dict[str, Any]:
        """Load a YAML file, recursively resolving ``_BASE_`` parents.

        Matches reference ``config.py:35-95``: child keys overwrite parent
        keys; nested dicts merge recursively; the ``_BASE_`` path is
        interpreted relative to the child file unless absolute.
        """
        import yaml  # here, so that a host without pyyaml imports the module

        with open(filename, "r") as f:
            cfg = yaml.safe_load(f) or {}

        def merge_a_into_b(a: Dict[str, Any], b: Dict[str, Any]) -> None:
            for k, v in a.items():
                if isinstance(v, dict) and k in b:
                    if not isinstance(b[k], dict):
                        raise ValueError(
                            "Cannot inherit key '{}' from base!".format(k)
                        )
                    merge_a_into_b(v, b[k])
                else:
                    b[k] = v

        if BASE_KEY in cfg:
            base_cfg_file = cfg[BASE_KEY]
            if base_cfg_file.startswith("~"):
                base_cfg_file = os.path.expanduser(base_cfg_file)
            if not base_cfg_file.startswith(("/", "http://", "https://")):
                base_cfg_file = os.path.join(
                    os.path.dirname(filename), base_cfg_file
                )
            base_cfg = CfgNode.load_yaml_with_base(base_cfg_file)
            del cfg[BASE_KEY]
            merge_a_into_b(cfg, base_cfg)
            return base_cfg
        return cfg

    def merge_from_file(self, cfg_filename: str) -> None:
        loaded = CfgNode.load_yaml_with_base(cfg_filename)
        self.merge_from_other_cfg(CfgNode(loaded))

    def merge_from_other_cfg(self, other: "CfgNode") -> None:
        if BASE_KEY in other:
            raise ValueError(
                "The reserved key '{}' can only be used in files!".format(BASE_KEY)
            )

        def merge(a: Dict[str, Any], b: Dict[str, Any]) -> None:
            for k, v in a.items():
                if isinstance(v, dict) and isinstance(b.get(k), dict):
                    merge(v, b[k])
                else:
                    b[k] = v

        merge(other, self)

    def merge_from_list(self, cfg_list: List[str]) -> None:
        if len(cfg_list) % 2 != 0:
            raise ValueError("Override list must have even length: {}".format(cfg_list))
        if BASE_KEY in cfg_list[0::2]:
            raise ValueError(
                "The reserved key '{}' can only be used in files!".format(BASE_KEY)
            )
        for key, value in zip(cfg_list[0::2], cfg_list[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                if p not in node:
                    node[p] = CfgNode()
                node = node[p]
            node[parts[-1]] = _decode_value(value)
