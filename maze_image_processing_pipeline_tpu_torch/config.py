"""Self-documenting YAML config framework.

Capability parity with ``maze_ipp/config.py``:

* :func:`generate_yaml_example` renders a commented YAML example from a
  pydantic model.  The *output format* is a contract shared with the
  reference (the docs embed it and task files round-trip through it):
  every field carries its description as ``## `` comment lines prefixed
  with a ``[required]``/``[optional]`` tag; optional fields and union
  alternatives appear commented out, the latter separated by ``## OR ##``
  markers; nested models indent; ``debug``-flagged fields are hidden; a
  missing description is an error.
* :class:`DefaultModel` — a scalar shortform is routed to a designated
  field (``threshold_brighter: 43`` can be written as ``threshold: 43``).
* :class:`TrueToDefaultsModel` — the literal ``true`` expands to
  all-defaults.

The implementation here is a two-pass design: :func:`_inspect_model` walks
the pydantic schema once and builds a small example-node tree
(:class:`_Value` / :class:`_Nested` / :class:`_OneOf` under :class:`_Entry`),
and :func:`_render_section` turns that tree into the commented YAML text.
Keeping schema interpretation separate from text layout makes each rule of
the format contract a single obvious branch in one of the two passes.

Copy of ``maze_image_processing_pipeline_tpu/config.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import json
import re
import textwrap
from dataclasses import dataclass
from types import NoneType, UnionType
from typing import (
    Any,
    ClassVar,
    List,
    Literal,
    Mapping,
    Type,
    Union,
    get_args,
    get_origin,
)

from pydantic import BaseModel, model_validator
from pydantic.fields import FieldInfo
from pydantic_core import PydanticUndefined

__all__ = ["generate_yaml_example", "DefaultModel", "TrueToDefaultsModel"]

# ---------------------------------------------------------------------------
# Pass 1: schema -> example-node tree


@dataclass
class _Value:
    """A scalar example, rendered as ``name: <text>``."""

    text: str


@dataclass
class _Nested:
    """A nested model block, rendered as ``name:`` plus an indented section."""

    section: "_Section"


@dataclass
class _OneOf:
    """Union alternatives; each option renders commented-out, OR-separated."""

    options: List[Any]  # _Value | _Nested


@dataclass
class _Entry:
    """One config field: its doc text, requiredness, and example node."""

    name: str
    doc: str
    required: bool
    node: Any  # _Value | _Nested | _OneOf


@dataclass
class _Section:
    """An ordered group of entries (one pydantic model's visible fields)."""

    entries: List[_Entry]


def _is_model(tp: Any) -> bool:
    return isinstance(tp, type) and issubclass(tp, BaseModel)


def _placeholder_value(default: Any) -> _Value:
    if default is PydanticUndefined:
        return _Value("...")
    return _Value(json.dumps(default))


def _inspect_field(ann: Any, default: Any) -> tuple[Any, bool]:
    """Classify one field annotation into an example node + requiredness."""
    if get_origin(ann) in {Union, UnionType}:
        options: List[Any] = []
        saw_wildcard = False
        for alt in get_args(ann):
            if alt is NoneType:
                continue  # Optional[...]: None needs no example line
            if get_origin(alt) is Literal:
                options.append(_Value(json.dumps(get_args(alt)[0])))
            elif _is_model(alt):
                options.append(_Nested(_inspect_model(alt)))
            elif not saw_wildcard:
                # All remaining plain types collapse into one "..." line.
                options.append(_Value("..."))
                saw_wildcard = True
        return _OneOf(options), False

    if default is not PydanticUndefined:
        return _placeholder_value(default), False

    if _is_model(ann):
        return _Nested(_inspect_model(ann)), True

    return _Value("..."), True


def _is_hidden(field: FieldInfo) -> bool:
    extra = field.json_schema_extra
    return isinstance(extra, Mapping) and bool(extra.get("debug", False))


def _inspect_model(model: Type[BaseModel]) -> _Section:
    entries = []
    for name, field in model.model_fields.items():
        if _is_hidden(field):
            continue
        if field.annotation is None:
            raise ValueError(f"{name} has no annotation")
        if field.description is None:
            raise ValueError(f"{name} has no description")
        node, required = _inspect_field(field.annotation, field.default)
        entries.append(_Entry(name, _strip_sphinx(field.description), required, node))
    return _Section(entries)


# ---------------------------------------------------------------------------
# Pass 2: example-node tree -> commented YAML text

_SPHINX_ATTR = re.compile(r":attr:`([^`]*)`", flags=re.MULTILINE)


def _strip_sphinx(description: str) -> str:
    """Rewrite ``:attr:`~a.b.c``` roles to plain backticked names."""

    def plain(m: re.Match) -> str:
        target = m.group(1)
        if target.startswith("~"):
            target = target.rsplit(".")[-1]
        return f"`{target}`"

    return _SPHINX_ATTR.sub(plain, description)


def _doc_comment(entry: _Entry) -> List[str]:
    """The ``## ``-prefixed, wrapped doc lines, tagged with requiredness."""
    tag = "required" if entry.required else "optional"
    out = []
    for raw_line in f"[{tag}] {entry.doc}".splitlines():
        wrapped = textwrap.fill(raw_line, break_on_hyphens=False)
        out.append(textwrap.indent(wrapped, "## "))
    return out


def _render_option(name: str, option: Any, depth: int) -> str:
    """One union alternative; always commented out."""
    if isinstance(option, _Nested):
        body = _render_section(option.section, depth + 1)
        return f"# {name}:\n" + textwrap.indent(body, "#   ")
    return f"# {name}: {option.text}"


def _render_example(entry: _Entry, depth: int) -> str:
    node = entry.node
    if isinstance(node, _OneOf):
        return "\n# ## OR ##\n".join(
            _render_option(entry.name, opt, depth) for opt in node.options
        )
    if isinstance(node, _Nested):
        body = _render_section(node.section, depth + 1)
        return f"{entry.name}:\n" + textwrap.indent(body, "  " * depth)
    prefix = "" if entry.required else "# "
    return f"{prefix}{entry.name}: {node.text}"


def _render_section(section: _Section, depth: int) -> str:
    blocks = []
    for entry in section.entries:
        lines = _doc_comment(entry)
        lines.append(_render_example(entry, depth))
        blocks.append("\n".join(lines))
    return "\n\n".join(blocks)


def generate_yaml_example(model: Type[BaseModel], depth: int = 1) -> str:
    """Render a commented YAML example for a pydantic model class."""
    return _render_section(_inspect_model(model), depth)


# ---------------------------------------------------------------------------
# Shortform models


class DefaultModel(BaseModel):
    """A model that accepts a scalar shortform routed to ``__default_field__``."""

    __default_field__: ClassVar[str]

    @model_validator(mode="before")
    @classmethod
    def _expand_shortform(cls, data: Any):
        if isinstance(data, Mapping):
            return data
        return {cls.__default_field__: data}


class TrueToDefaultsModel(BaseModel):
    """A model where the literal ``true`` means "enable with all defaults"."""

    @model_validator(mode="before")
    @classmethod
    def _expand_shortform(cls, data: Any):
        return {} if data is True else data
