"""Core of the streaming dataflow engine: Pipeline, Node, Variable, Stream.

Programming-model parity with the reference's external engine (morphocut, see
``SURVEY.md`` §1 L2 / §2b): instantiating a node inside ``with Pipeline():``
registers it with the graph; node "outputs" are lazy :class:`Variable`
handles; execution pushes :class:`StreamObject` s through chained
``transform_stream`` generators.  Internals are a fresh design.

Copy of ``maze_image_processing_pipeline_tpu/engine/core.py`` for the PyTorch port,
which imports nothing of the JAX package; only imports differ.
``tests/test_torch_host_copies.py`` holds the two equal.
"""

from __future__ import annotations

import contextlib
import itertools
import operator
import threading
from typing import (
    Any,
    Callable,
    Dict,
    Generic,
    Iterable,
    Iterator,
    List,
    Optional,
    Sequence,
    Tuple,
    TypeVar,
    Union,
)

T = TypeVar("T")

__all__ = [
    "Variable",
    "StreamObject",
    "Stream",
    "Node",
    "Pipeline",
    "Call",
    "Output",
    "ReturnOutputs",
    "RawOrVariable",
    "closing_if_closable",
]


_var_counter = itertools.count()
_var_lock = threading.Lock()


def _next_var_id() -> int:
    with _var_lock:
        return next(_var_counter)


class Variable(Generic[T]):
    """A lazy handle to a per-object value produced by a node.

    Variables support common operators (``>``, ``+``, ``[...]``, attribute
    access, calls) which insert small derived-value nodes into the active
    pipeline — e.g. ``mask = image > 128`` or ``meta["object_frame_id"]``.
    """

    __slots__ = ("id", "name", "node")

    def __init__(self, name: str = "?", node: Optional["Node"] = None) -> None:
        self.id = _next_var_id()
        self.name = name
        self.node = node

    def __repr__(self) -> str:
        return f"<Variable {self.name}#{self.id}>"

    def __hash__(self) -> int:
        return self.id

    # hash/eq by identity: Variables are graph handles, not values.
    def __eq__(self, other) -> bool:  # pragma: no cover - identity semantics
        return self is other

    # --- derived-value operators (each creates a node in the active pipeline)

    def _derive(self, name: str, fn: Callable, *args) -> "Variable":
        return Call._create(fn, (self, *args), {}, name=name)

    def __getitem__(self, key) -> "Variable":
        return self._derive(f"{self.name}[{key!r}]", operator.getitem, key)

    def __getattr__(self, attr: str) -> "Variable":
        if attr.startswith("_"):
            raise AttributeError(attr)
        return self._derive(f"{self.name}.{attr}", getattr, attr)

    def __call__(self, *args, **kwargs) -> "Variable":
        return Call._create(
            lambda f, *a, **k: f(*a, **k), (self, *args), kwargs, name=f"{self.name}()"
        )

    def __gt__(self, other) -> "Variable":
        return self._derive(f"{self.name}>", operator.gt, other)

    def __ge__(self, other) -> "Variable":
        return self._derive(f"{self.name}>=", operator.ge, other)

    def __lt__(self, other) -> "Variable":
        return self._derive(f"{self.name}<", operator.lt, other)

    def __le__(self, other) -> "Variable":
        return self._derive(f"{self.name}<=", operator.le, other)

    def __add__(self, other) -> "Variable":
        return self._derive(f"{self.name}+", operator.add, other)

    def __radd__(self, other) -> "Variable":
        return Call._create(operator.add, (other, self), {}, name=f"+{self.name}")

    def __mul__(self, other) -> "Variable":
        return self._derive(f"{self.name}*", operator.mul, other)

    def __sub__(self, other) -> "Variable":
        return self._derive(f"{self.name}-", operator.sub, other)

    def __truediv__(self, other) -> "Variable":
        return self._derive(f"{self.name}/", operator.truediv, other)

    def __invert__(self) -> "Variable":
        return self._derive(f"~{self.name}", operator.invert)

    def unpack(self, n: int) -> Tuple["Variable", ...]:
        """Split a tuple-valued variable into ``n`` separate variables."""
        return tuple(
            self._derive(f"{self.name}[{i}]", operator.getitem, i) for i in range(n)
        )


RawOrVariable = Union[T, Variable]


class StreamObject:
    """One unit of work flowing through the stream; maps Variables to values."""

    __slots__ = ("values", "n_remaining_hint")

    def __init__(
        self,
        values: Optional[Dict[int, Any]] = None,
        n_remaining_hint: Optional[float] = None,
    ) -> None:
        self.values: Dict[int, Any] = values if values is not None else {}
        self.n_remaining_hint = n_remaining_hint

    def __getitem__(self, var: Variable):
        try:
            return self.values[var.id]
        except KeyError:
            raise KeyError(
                f"{var!r} is not available on this stream object. "
                f"Was its producing node executed upstream?"
            ) from None

    def __setitem__(self, var: Variable, value) -> None:
        self.values[var.id] = value

    def __contains__(self, var: Variable) -> bool:
        return var.id in self.values

    def copy(self) -> "StreamObject":
        return StreamObject(dict(self.values), self.n_remaining_hint)


Stream = Iterator[StreamObject]


def closing_if_closable(stream) -> contextlib.AbstractContextManager:
    """Context manager that closes a generator-backed stream on exit."""
    if hasattr(stream, "close"):
        return contextlib.closing(stream)
    return contextlib.nullcontext(stream)


# ---------------------------------------------------------------------------
# Pipeline context machinery


_local = threading.local()


def _context_stack() -> List["Pipeline"]:
    stack = getattr(_local, "pipeline_stack", None)
    if stack is None:
        stack = _local.pipeline_stack = []
    return stack


class Node:
    """Base class for stream-transforming nodes.

    Subclasses either override :meth:`transform_stream` (full control over the
    stream) or :meth:`transform` (pure per-object mapping over declared
    inputs). Output variables are declared with the :func:`Output` /
    :func:`ReturnOutputs` decorators.
    """

    outputs: Sequence[str] = ()

    def __init__(self) -> None:
        self.output_vars: Tuple[Variable, ...] = tuple(
            Variable(f"{type(self).__name__}.{name}", self) for name in type(self).outputs
        )
        self._register()

    def _register(self) -> None:
        stack = _context_stack()
        if stack:
            stack[-1]._add_child(self)

    # -- value plumbing

    def prepare_input(self, obj: StreamObject, names):
        """Resolve the attribute(s) ``names`` (Raw or Variable) for ``obj``."""
        if isinstance(names, str):
            return self._resolve(obj, getattr(self, names))
        return tuple(self._resolve(obj, getattr(self, name)) for name in names)

    @staticmethod
    def _resolve(obj: StreamObject, value):
        if isinstance(value, Variable):
            return obj[value]
        if isinstance(value, tuple):
            return tuple(Node._resolve(obj, v) for v in value)
        if isinstance(value, list):
            return [Node._resolve(obj, v) for v in value]
        return value

    def prepare_output(self, obj: StreamObject, *values) -> StreamObject:
        if len(self.output_vars) != len(values):
            raise ValueError(
                f"{type(self).__name__} declares {len(self.output_vars)} outputs "
                f"but prepare_output got {len(values)} values"
            )
        for var, value in zip(self.output_vars, values):
            obj[var] = value
        return obj

    # -- execution

    def transform_stream(self, stream: Stream) -> Stream:
        """Default: map :meth:`transform` over declared inputs per object."""
        # Resolve the input-name list once: the default _input_names runs
        # inspect.signature, which is far too slow per stream object.
        input_names = tuple(self._input_names())
        with closing_if_closable(stream):
            for obj in stream:
                try:
                    inputs = {
                        name: self._resolve(obj, getattr(self, name))
                        for name in input_names
                    }
                    result = self.transform(**inputs)
                except Exception as exc:
                    _annotate(exc, f" [in {self}]")
                    raise
                if len(self.output_vars) == 1:
                    self.prepare_output(obj, result)
                elif len(self.output_vars) > 1:
                    self.prepare_output(obj, *result)
                yield obj

    def _input_names(self) -> Sequence[str]:
        import inspect

        sig = inspect.signature(self.transform)
        return [p for p in sig.parameters]

    def transform(self, **kwargs):  # pragma: no cover - abstract default
        raise NotImplementedError(
            f"{type(self).__name__} must override transform or transform_stream"
        )

    def __str__(self) -> str:
        return type(self).__name__

    def __call__(self):
        """Return this node's output variables (parity helper)."""
        return _outputs_or_node(self)


def _annotate(exc: BaseException, msg: str) -> None:
    try:
        exc.add_note(msg)
    except AttributeError:  # pragma: no cover - py<3.11
        exc.args = (*exc.args, msg)


def _outputs_or_node(node: Node):
    if len(node.output_vars) == 1:
        return node.output_vars[0]
    if node.output_vars:
        return node.output_vars
    return node


def Output(name: str):
    """Class decorator declaring one output variable (applied bottom-up)."""

    def wrap(cls):
        cls.outputs = (name, *getattr(cls, "outputs", ()))
        return cls

    return wrap


def ReturnOutputs(cls):
    """Class decorator: constructing the node returns its output Variables."""

    def _factory(*args, **kwargs):
        node = cls(*args, **kwargs)
        return _outputs_or_node(node)

    _factory.node_class = cls
    _factory.__name__ = cls.__name__
    _factory.__qualname__ = cls.__qualname__
    _factory.__doc__ = cls.__doc__
    return _factory


class Pipeline(Node):
    """A (possibly nested) group of nodes.

    Used as a context manager during graph construction; nodes created inside
    the ``with`` block become children. A Pipeline constructed inside another
    pipeline context acts as a single composite node there.
    """

    def __init__(self) -> None:
        self.children: List[Node] = []
        super().__init__()

    def _add_child(self, node: Node) -> None:
        self.children.append(node)

    def __enter__(self) -> "Pipeline":
        _context_stack().append(self)
        return self

    def __exit__(self, *exc_info) -> None:
        popped = _context_stack().pop()
        assert popped is self

    # -- execution

    def _chain_children(self, stream: Stream) -> Stream:
        for child in self.children:
            stream = child.transform_stream(stream)
        return stream

    def transform_stream(self, stream: Stream) -> Stream:
        return self._chain_children(stream)

    def run(self, stream: Optional[Iterable[StreamObject]] = None) -> List[StreamObject]:
        """Execute the graph, draining the final stream. Returns drained objects."""
        if stream is None:
            stream = iter([StreamObject(n_remaining_hint=1)])
        return list(self.transform_stream(iter(stream)))


class _CallNode(Node):
    """Apply an arbitrary host function to resolved arguments per object."""

    outputs = ("result",)

    def __init__(self, fn: Callable, args: tuple, kwargs: dict, name: Optional[str] = None):
        self.fn = fn
        self.args = args
        self.kwargs = kwargs
        self._name = name or getattr(fn, "__name__", str(fn))
        super().__init__()
        self.output_vars[0].name = self._name

    def transform_stream(self, stream: Stream) -> Stream:
        with closing_if_closable(stream):
            for obj in stream:
                try:
                    args = [self._resolve(obj, a) for a in self.args]
                    kwargs = {k: self._resolve(obj, v) for k, v in self.kwargs.items()}
                    result = self.fn(*args, **kwargs)
                except Exception as exc:
                    _annotate(exc, f" [in Call({self._name})]")
                    raise
                obj[self.output_vars[0]] = result
                yield obj

    def __str__(self) -> str:
        return f"Call({self._name})"


def Call(fn: Callable, *args, **kwargs) -> Variable:
    """Insert a host-function node; returns the lazy result Variable."""
    node = _CallNode(fn, args, kwargs)
    return node.output_vars[0]


def _call_create(fn, args, kwargs, name=None) -> Variable:
    node = _CallNode(fn, tuple(args), dict(kwargs), name=name)
    return node.output_vars[0]


Call._create = staticmethod(_call_create)  # type: ignore[attr-defined]
