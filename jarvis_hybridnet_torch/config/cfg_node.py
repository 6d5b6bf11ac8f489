"""Minimal yacs-style configuration node.

A copy of ``jarvis_hybridnet_tpu/config/cfg_node.py``, so that the port
imports nothing of the JAX package: attribute access, nested nodes, YAML
merge of per-project overrides, and clone/dump. ``yaml`` is imported only by
the two methods that read or write YAML, so the predictor runs on machines
without pyyaml.
"""

from __future__ import annotations

import copy
import io
from typing import Any, Mapping


class CfgNode(dict):
    """A dict with attribute access and recursive YAML merging."""

    def __init__(self, init: Mapping[str, Any] | None = None):
        super().__init__()
        if init:
            for k, v in init.items():
                self[k] = CfgNode(v) if isinstance(v, Mapping) else v

    # -- attribute access -------------------------------------------------
    def __getattr__(self, name: str) -> Any:
        try:
            return self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        try:
            del self[name]
        except KeyError as e:
            raise AttributeError(name) from e

    # -- merging -----------------------------------------------------------
    def merge_from_other_cfg(self, other: Mapping[str, Any]) -> None:
        _merge_into(other, self)

    def merge_from_file(self, filename: str) -> None:
        import yaml

        with open(filename, "r") as f:
            loaded = yaml.safe_load(f)
        if loaded is None:
            return
        _merge_into(loaded, self)

    def merge_from_list(self, opts: list) -> None:
        assert len(opts) % 2 == 0, "override list must be key/value pairs"
        for key, value in zip(opts[0::2], opts[1::2]):
            node = self
            parts = key.split(".")
            for p in parts[:-1]:
                node = node[p]
            node[parts[-1]] = value

    # -- utils --------------------------------------------------------------
    def clone(self) -> "CfgNode":
        return copy.deepcopy(self)

    def dump(self) -> str:
        import yaml

        out = io.StringIO()
        yaml.safe_dump(_to_plain(self), out, default_flow_style=False)
        return out.getvalue()


def _to_plain(node: Any) -> Any:
    if isinstance(node, dict):
        return {k: _to_plain(v) for k, v in node.items()}
    return node


def _merge_into(src: Mapping[str, Any], dst: CfgNode) -> None:
    for k, v in src.items():
        if isinstance(v, Mapping):
            if k not in dst or not isinstance(dst.get(k), CfgNode):
                dst[k] = CfgNode()
            _merge_into(v, dst[k])
        else:
            dst[k] = v
