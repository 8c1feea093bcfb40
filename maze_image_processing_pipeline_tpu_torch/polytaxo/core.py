"""Polyhierarchical taxonomy: tree, descriptions, expressions, decoding.

Concepts (matching the behavioral contract at ``predict/pipeline.py``):

* **PrimaryNode** — a node of the main taxonomic hierarchy (Copepoda >
  Calanoida > Calanus ...). May carry a classifier output ``index``, name
  ``alias`` es (with ``*`` wildcards) and free-form ``meta`` (e.g.
  ``predict: false`` to exclude a node from predicted output).
* **TagNode** — a qualifier (e.g. ``oil-sack``, ``egg``) attached to a
  primary node's subtree; tags may be hierarchical.
* **VirtualNode** — a named shortcut whose meaning is a full
  :class:`Description` (used to translate to EcoTaxa morpho-taxa).
* **NegatedRealNode** — negation marker of a primary/tag node (``!egg``).
* **Description** — an *anchor* (most specific primary node) plus a set of
  qualifiers (tags / negated nodes). Total content of an annotation.
* **Expression** — parsed query/update: ``match(description)`` tests
  containment; ``apply(description)`` adds/removes descriptors.

Taxonomy YAML format (``PolyTaxonomy.from_dict``)::

    Copepoda:
      _index: 0
      _alias: ["Copepod*"]
      _tags:
        oil-sack: 7            # shorthand: classifier index
        egg:
          _index: 8
      _virtuals:
        with-oil: "Copepoda oil-sack"
      Calanoida:
        _index: 1
        Calanus: 2             # shorthand: classifier index

Keys not starting with ``_`` are child primary nodes.

Copy of ``maze_image_processing_pipeline_tpu/polytaxo/core.py`` for the PyTorch
port, which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import fnmatch
from typing import Dict, Iterable, List, Mapping, Optional, Sequence, Tuple, Union

import numpy as np

__all__ = [
    "PrimaryNode",
    "TagNode",
    "VirtualNode",
    "NegatedRealNode",
    "Description",
    "Expression",
    "PolyTaxonomy",
]


class _RealNode:
    """Shared behavior of primary and tag nodes."""

    def __init__(self, name: str, parent=None, index: Optional[int] = None,
                 alias: Sequence[str] = (), meta: Optional[Dict] = None) -> None:
        self.name = name
        self.parent = parent
        self.index = index
        self.alias = list(alias)
        self.meta = dict(meta or {})

    def matches_name(self, name: str, with_alias: bool = True) -> bool:
        if self.name == name:
            return True
        if with_alias:
            return any(fnmatch.fnmatch(name, a) for a in self.alias)
        return False

    def ancestors(self):
        node = self
        while node is not None:
            yield node
            node = node.parent

    def is_descendant_of(self, other) -> bool:
        return any(a is other for a in self.ancestors())

    def __repr__(self) -> str:
        return f"<{type(self).__name__} {self.name}>"


class PrimaryNode(_RealNode):
    def __init__(self, name, parent=None, index=None, alias=(), meta=None):
        super().__init__(name, parent, index, alias, meta)
        self.children: List[PrimaryNode] = []
        self.tags: List[TagNode] = []
        self.virtuals: List[VirtualNode] = []

    @property
    def path(self) -> List["PrimaryNode"]:
        nodes = [a for a in self.ancestors() if isinstance(a, PrimaryNode)]
        return list(reversed(nodes))

    @property
    def path_name(self) -> str:
        # Root is implicit and omitted from printed paths.
        names = [n.name for n in self.path[1:]]
        return ">".join(names) if names else self.name

    def applicable_tags(self) -> List["TagNode"]:
        """Tags declared on this node or any primary ancestor (recursively)."""
        out: List[TagNode] = []
        for node in self.ancestors():
            if isinstance(node, PrimaryNode):
                for tag in node.tags:
                    out.extend(_iter_tag_tree(tag))
        return out

    def get_applicable_virtuals(self) -> List["VirtualNode"]:
        out: List[VirtualNode] = []
        for node in self.ancestors():
            if isinstance(node, PrimaryNode):
                out.extend(node.virtuals)
        return out


def _iter_tag_tree(tag: "TagNode"):
    yield tag
    for child in tag.children:
        yield from _iter_tag_tree(child)


class TagNode(_RealNode):
    def __init__(self, name, parent=None, index=None, alias=(), meta=None):
        super().__init__(name, parent, index, alias, meta)
        self.children: List[TagNode] = []


class VirtualNode:
    """A named shortcut for a full description."""

    def __init__(self, name: str, description: "Description", parent: PrimaryNode):
        self.name = name
        self.description = description
        self.parent = parent

    def __repr__(self) -> str:
        return f"<VirtualNode {self.name} = {self.description}>"


class NegatedRealNode:
    """Negation of a primary or tag node."""

    __slots__ = ("node",)

    def __init__(self, node: _RealNode) -> None:
        self.node = node

    def __eq__(self, other) -> bool:
        return isinstance(other, NegatedRealNode) and other.node is self.node

    def __hash__(self) -> int:
        return hash(("neg", id(self.node)))

    def __repr__(self) -> str:
        return f"!{self.node.name}"


class Description:
    """An anchor primary node plus a set of qualifiers."""

    def __init__(self, anchor: PrimaryNode, qualifiers: Iterable = ()) -> None:
        self.anchor = anchor
        self.qualifiers: List = []
        for q in qualifiers:
            self._add_qualifier(q)

    # -- construction --------------------------------------------------

    def copy(self) -> "Description":
        return Description(self.anchor, list(self.qualifiers))

    @property
    def descriptors(self) -> List:
        """All descriptors: the anchor followed by the qualifiers."""
        return [self.anchor, *self.qualifiers]

    def _add_qualifier(self, q) -> None:
        if isinstance(q, NegatedRealNode):
            # Negation removes the positive (and its descendants).
            self.qualifiers = [
                x
                for x in self.qualifiers
                if not (isinstance(x, TagNode) and (x is q.node or x.is_descendant_of(q.node)))
            ]
            if q not in self.qualifiers:
                self.qualifiers.append(q)
            return
        if isinstance(q, TagNode):
            # Adding a tag removes its negation and redundant ancestors.
            self.qualifiers = [
                x
                for x in self.qualifiers
                if not (isinstance(x, NegatedRealNode) and (q is x.node or q.is_descendant_of(x.node)))
                and not (isinstance(x, TagNode) and q.is_descendant_of(x) and q is not x)
            ]
            # Skip if an equal-or-more-specific tag is present.
            for x in self.qualifiers:
                if isinstance(x, TagNode) and (x is q or x.is_descendant_of(q)):
                    return
            self.qualifiers.append(q)
            return
        raise TypeError(f"Cannot add qualifier of type {type(q)}")

    def update(self, descriptors: Iterable) -> "Description":
        """Add descriptors (primary nodes deepen the anchor); returns self."""
        for d in descriptors:
            if isinstance(d, PrimaryNode):
                if d.is_descendant_of(self.anchor):
                    self.anchor = d
                elif not self.anchor.is_descendant_of(d):
                    raise ValueError(
                        f"Incompatible primary nodes: {self.anchor.name} vs {d.name}"
                    )
            elif isinstance(d, Description):
                self.add(d)
            else:
                self._add_qualifier(d)
        return self

    def add(self, other: "Description") -> "Description":
        """Merge another description into this one; returns self."""
        self.update([other.anchor, *other.qualifiers])
        return self

    # -- queries ---------------------------------------------------------

    def contains(self, descriptor) -> bool:
        if isinstance(descriptor, PrimaryNode):
            return self.anchor is descriptor or self.anchor.is_descendant_of(descriptor)
        if isinstance(descriptor, TagNode):
            return any(
                isinstance(q, TagNode) and (q is descriptor or q.is_descendant_of(descriptor))
                for q in self.qualifiers
            )
        if isinstance(descriptor, NegatedRealNode):
            return descriptor in self.qualifiers
        return False

    def __le__(self, other: "Description") -> bool:
        """self ≤ other: other is at least as specific as self."""
        return all(other.contains(d) for d in self.descriptors)

    def __eq__(self, other) -> bool:
        return (
            isinstance(other, Description)
            and self.anchor is other.anchor
            and set(map(str, self.qualifiers)) == set(map(str, other.qualifiers))
        )

    def __hash__(self) -> int:
        return hash(str(self))

    def __str__(self) -> str:
        parts = [self.anchor.path_name] if self.anchor.parent is not None else []
        names = []
        for q in self.qualifiers:
            if isinstance(q, NegatedRealNode):
                names.append(f"!{q.node.name}")
            else:
                names.append(q.name)
        parts.extend(sorted(names))
        return " ".join(parts)

    def __repr__(self) -> str:
        return f"<Description {self}>"


class Expression:
    """A parsed query/update expression: a list of (negated, node) terms."""

    def __init__(self, terms: List[Tuple[bool, object]], source: str = "") -> None:
        self.terms = terms
        self.source = source

    def match(self, description: Description) -> bool:
        """All positive terms contained; all negated terms absent."""
        for negated, node in self.terms:
            if isinstance(node, VirtualNode):
                ok = node.description <= description
            else:
                ok = description.contains(node)
            if negated:
                # A negated primary/tag term matches when the positive is
                # absent (explicit negation also counts as absent-positive).
                if ok:
                    return False
            elif not ok:
                return False
        return True

    def apply(self, description: Description) -> Description:
        """Return a new description with the expression's updates applied."""
        out = description.copy()
        for negated, node in self.terms:
            if isinstance(node, VirtualNode):
                if negated:
                    raise ValueError("Cannot negate a virtual node in an update")
                out.add(node.description)
            elif negated:
                if isinstance(node, PrimaryNode):
                    # Negating a primary node retreats the anchor above it.
                    if out.anchor is node or out.anchor.is_descendant_of(node):
                        out.anchor = node.parent or out.anchor
                else:
                    out._add_qualifier(NegatedRealNode(node))
            else:
                out.update([node])
        return out

    def __repr__(self) -> str:
        return f"<Expression {self.source!r}>"


class PolyTaxonomy:
    """The taxonomy: primary tree + tags + virtuals, with decoding."""

    def __init__(self, root: PrimaryNode) -> None:
        self.root = root
        self._index_to_node: Dict[int, _RealNode] = {}

        def register(n) -> None:
            if n.index is None:
                return
            other = self._index_to_node.get(n.index)
            if other is not None and other is not n:
                raise ValueError(
                    f"Duplicate classifier index {n.index}: "
                    f"{other.name!r} and {n.name!r}"
                )
            self._index_to_node[n.index] = n

        for node in self.iter_primary():
            register(node)
            for tag_root in node.tags:
                for tag in _iter_tag_tree(tag_root):
                    register(tag)

    # -- construction ------------------------------------------------------

    @classmethod
    def from_dict(cls, data: Mapping) -> "PolyTaxonomy":
        root = PrimaryNode("", parent=None)
        deferred_virtuals: List[Tuple[PrimaryNode, str, str]] = []

        _TAG_KEYS = ("_index", "_alias", "_meta", "_children")

        def build_tags(spec: Mapping, parent) -> List[TagNode]:
            tags = []
            for name, value in spec.items():
                if isinstance(value, int):
                    tag = TagNode(name, parent=parent, index=value)
                elif isinstance(value, Mapping) or value is None:
                    value = value or {}
                    unknown = [
                        k
                        for k in value
                        if k.startswith("_") and k not in _TAG_KEYS
                    ]
                    if unknown:
                        raise ValueError(
                            f"Unknown tag key(s) for {name!r}: {unknown}"
                        )
                    tag = TagNode(
                        name,
                        parent=parent,
                        index=value.get("_index"),
                        alias=value.get("_alias", ()),
                        meta=value.get("_meta", {}),
                    )
                    # Child tags nest either under _children or as plain
                    # keys (the same style primary children use); plain
                    # keys used to be silently DROPPED.
                    child_spec = dict(value.get("_children") or {})
                    for k, v in value.items():
                        if not k.startswith("_"):
                            child_spec[k] = v
                    tag.children = build_tags(child_spec, tag)
                else:
                    raise ValueError(f"Bad tag spec for {name!r}: {value!r}")
                tags.append(tag)
            return tags

        def build(node: PrimaryNode, spec: Mapping) -> None:
            for name, value in spec.items():
                if name == "_index":
                    node.index = value
                elif name == "_alias":
                    node.alias = list(value)
                elif name == "_meta":
                    node.meta = dict(value)
                elif name == "_tags":
                    node.tags = build_tags(value, node)
                elif name == "_virtuals":
                    for vname, vexpr in value.items():
                        deferred_virtuals.append((node, vname, vexpr))
                elif name.startswith("_"):
                    raise ValueError(f"Unknown taxonomy key: {name!r}")
                else:
                    if isinstance(value, int):
                        child = PrimaryNode(name, parent=node, index=value)
                    else:
                        child = PrimaryNode(name, parent=node)
                        build(child, value or {})
                    node.children.append(child)

        build(root, data)
        taxonomy = cls(root)

        # Virtual descriptions may reference any node; resolve after build.
        for parent, vname, vexpr in deferred_virtuals:
            expr = taxonomy.parse_expression(vexpr)
            description = expr.apply(Description(taxonomy.root))
            parent.virtuals.append(VirtualNode(vname, description, parent))

        return taxonomy

    # -- traversal -----------------------------------------------------------

    def iter_primary(self):
        def walk(node):
            yield node
            for child in node.children:
                yield from walk(child)

        yield from walk(self.root)

    def format_tree(self) -> str:
        lines: List[str] = []

        def fmt_tags(tag: TagNode, depth: int) -> None:
            idx = f" [{tag.index}]" if tag.index is not None else ""
            lines.append("  " * depth + f"+ {tag.name}{idx}")
            for child in tag.children:
                fmt_tags(child, depth + 1)

        def walk(node: PrimaryNode, depth: int) -> None:
            idx = f" [{node.index}]" if node.index is not None else ""
            lines.append("  " * depth + f"{node.name or '<root>'}{idx}")
            for tag in node.tags:
                fmt_tags(tag, depth + 1)
            for virtual in node.virtuals:
                lines.append("  " * (depth + 1) + f"~ {virtual.name} = {virtual.description}")
            for child in node.children:
                walk(child, depth + 1)

        walk(self.root, 0)
        return "\n".join(lines)

    # -- lookup ---------------------------------------------------------------

    def find_node(self, name: str, with_alias: bool = True):
        """Find a primary node, tag, or virtual by (possibly >-qualified) name."""
        if ">" in name:
            parts = name.split(">")
            node = self._find_primary_path(parts, with_alias)
            if node is not None:
                return node
            raise KeyError(name)

        for node in self.iter_primary():
            if node.matches_name(name, with_alias):
                return node
        for node in self.iter_primary():
            for tag_root in node.tags:
                for tag in _iter_tag_tree(tag_root):
                    if tag.matches_name(name, with_alias):
                        return tag
            for virtual in node.virtuals:
                if virtual.name == name:
                    return virtual
        raise KeyError(name)

    def _find_primary_path(self, parts: Sequence[str], with_alias: bool):
        node = self.root
        for part in parts:
            nxt = next(
                (c for c in node.children if c.matches_name(part, with_alias)), None
            )
            if nxt is None:
                return None
            node = nxt
        return node

    def get_description(
        self,
        parts: Sequence[str],
        ignore_missing_intermediaries: bool = False,
        with_alias: bool = True,
    ) -> Description:
        """Translate an EcoTaxa lineage (root→leaf names) to a Description.

        Each part may name a primary child (descending the hierarchy), a tag,
        or a virtual taxon. Unknown intermediate parts raise unless
        ``ignore_missing_intermediaries``.
        """
        description = Description(self.root)
        node = self.root
        for part in parts:
            part = part.strip()
            if not part:
                continue
            child = next(
                (c for c in node.children if c.matches_name(part, with_alias)), None
            )
            if child is not None:
                node = child
                description.update([child])
                continue
            # A deeper descendant (missing intermediaries)?
            descendant = self._find_descendant(node, part, with_alias)
            if descendant is not None and ignore_missing_intermediaries:
                node = descendant
                description.update([descendant])
                continue
            # Tag applicable at the current anchor?
            tag = next(
                (
                    t
                    for t in node.applicable_tags()
                    if t.matches_name(part, with_alias)
                ),
                None,
            )
            if tag is not None:
                description.update([tag])
                continue
            virtual = next(
                (v for v in node.get_applicable_virtuals() if v.name == part), None
            )
            if virtual is not None:
                description.add(virtual.description)
                node = description.anchor
                continue
            raise ValueError(f"Unknown lineage part: {part!r} (under {node.name!r})")
        return description

    @staticmethod
    def _find_descendant(node: PrimaryNode, name: str, with_alias: bool):
        stack = list(node.children)
        while stack:
            cur = stack.pop()
            if cur.matches_name(name, with_alias):
                return cur
            stack.extend(cur.children)
        return None

    # -- expressions ----------------------------------------------------------

    def parse_expression(self, text: str) -> Expression:
        """Parse ``"Copepoda>Calanoida oil-sack !egg"`` into an Expression."""
        terms: List[Tuple[bool, object]] = []
        for token in text.split():
            negated = token.startswith(("!", "-"))
            if negated:
                token = token[1:]
            node = self.find_node(token)
            terms.append((negated, node))
        return Expression(terms, source=text)

    # -- probability decoding ---------------------------------------------------

    def parse_probabilities(
        self,
        probabilities: np.ndarray,
        baseline: Optional[Description] = None,
        thr_pos_abs: float = 0.9,
        thr_neg: float = 0.1,
        thr_pos_rel: float = 0.0,
    ) -> Description:
        """Decode a classifier probability vector into a Description.

        Walks the primary hierarchy greedily: at each node the best-scoring
        child is accepted if its probability exceeds ``thr_pos_abs`` and
        beats the runner-up by ``thr_pos_rel``. Tags applicable at the final
        anchor are added when above ``thr_pos_abs`` and negated when below
        ``thr_neg``. A ``baseline`` description constrains the walk to
        refinements of its anchor and is merged into the result.
        """
        probabilities = np.asarray(probabilities).ravel()

        def prob(node) -> Optional[float]:
            if node.index is None or node.index >= probabilities.size:
                return None
            return float(probabilities[node.index])

        description = Description(self.root)
        if baseline is not None:
            description = baseline.copy()

        # Descend the primary hierarchy from the (baseline) anchor.
        node = description.anchor
        while True:
            scored = [(prob(c), c) for c in node.children]
            scored = [(p, c) for p, c in scored if p is not None]
            if not scored:
                break
            scored.sort(key=lambda pc: pc[0], reverse=True)
            best_p, best_c = scored[0]
            second_p = scored[1][0] if len(scored) > 1 else 0.0
            if best_p <= thr_pos_abs or best_p < second_p + thr_pos_rel:
                break
            node = best_c

        if node is not description.anchor:
            description.update([node])

        # Tags applicable at the final anchor.
        for tag in description.anchor.applicable_tags():
            p = prob(tag)
            if p is None:
                continue
            if p > thr_pos_abs:
                description.update([tag])
            elif p < thr_neg and not description.contains(tag):
                description.update([NegatedRealNode(tag)])

        return description
