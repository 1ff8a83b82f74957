"""YAML template loader (reference:
python/pathway/internals/yaml_loader.py — AI-pipeline templates
instantiate python objects from YAML via `!pw....` class tags and
`$variable` references; docs/2.developers/6.ai-pipelines/40.configure-yaml.md).
"""

from __future__ import annotations

import builtins
import importlib
import os
import re
from typing import Any, IO

import yaml

_VAR_RE = re.compile(r"^\$([A-Za-z_][A-Za-z0-9_]*)$")


def import_object(path: str) -> Any:
    """'pw.xpacks.llm.llms.OpenAIChat' or 'module:attr.path' -> object."""
    if path.startswith("pw.") or path.startswith("pw:"):
        path = "pathway_tpu_torch" + path.removeprefix("pw")
    module_path, colon, attribute_path = path.partition(":")
    attributes = attribute_path.split(".") if attribute_path else []
    module: Any = builtins
    if not colon:
        names = module_path.split(".")
        for index in range(len(names), 0, -1):
            prefix = ".".join(names[:index])
            try:
                module = importlib.import_module(prefix)
                attributes = names[index:]
                break
            except ImportError:
                continue
        else:
            raise ImportError(f"cannot import {path!r}")
    else:
        module = importlib.import_module(module_path)
    obj = module
    for attr in attributes:
        obj = getattr(obj, attr)
    return obj


class _Tagged:
    def __init__(self, path: str, value: Any):
        self.path = path
        self.value = value


class _Loader(yaml.SafeLoader):
    pass


def _multi_constructor(loader: _Loader, tag_suffix: str, node):
    if isinstance(node, yaml.MappingNode):
        value = loader.construct_mapping(node, deep=True)
    elif isinstance(node, yaml.SequenceNode):
        value = loader.construct_sequence(node, deep=True)
    else:
        value = loader.construct_scalar(node)
        if value == "":
            value = None
    return _Tagged(tag_suffix, value)


_Loader.add_multi_constructor("!", _multi_constructor)


def _resolve(value: Any, variables: dict[str, Any]) -> Any:
    if isinstance(value, _Tagged):
        obj = import_object(value.path)
        inner = _resolve(value.value, variables)
        if inner is None:
            return obj() if callable(obj) else obj
        if isinstance(inner, dict):
            return obj(**inner)
        if isinstance(inner, list):
            return obj(*inner)
        return obj(inner)
    if isinstance(value, dict):
        return {k: _resolve(v, variables) for k, v in value.items()}
    if isinstance(value, list):
        return [_resolve(v, variables) for v in value]
    if isinstance(value, str):
        m = _VAR_RE.match(value)
        if m:
            name = m.group(1)
            if name in variables:
                return variables[name]
            if name in os.environ:
                return os.environ[name]
            raise KeyError(f"undefined template variable ${name}")
    return value


def resolve_config_path(path: str, config_path: str) -> str:
    """Resolve a path from a template config relative to the config
    file's own directory (shared by the example apps)."""
    if os.path.isabs(path):
        return path
    return os.path.join(
        os.path.dirname(os.path.abspath(config_path)), path
    )


def load_yaml(stream: str | IO) -> Any:
    """Parse a template: `$name:` top-level keys define variables (resolved
    in order); `!dotted.path` tags instantiate objects with the nested
    mapping as kwargs."""
    raw = yaml.load(stream, Loader=_Loader)
    if not isinstance(raw, dict):
        return _resolve(raw, {})
    variables: dict[str, Any] = {}
    out: dict[str, Any] = {}
    for key, value in raw.items():
        m = _VAR_RE.match(str(key))
        if m:
            variables[m.group(1)] = _resolve(value, variables)
        else:
            out[key] = _resolve(value, variables)
    return out
