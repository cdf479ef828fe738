"""Serialization of functions, values and tensors for worker processes.

The reference pickles a process task's function by value with
``cloudpickle`` (``ray_tpu/core/process_pool.py``); the card's host is not
promised to have it, so the port carries its own, on the standard
library alone: ``pickle.Pickler.reducer_override`` plus ``marshal`` for
code objects (parent and worker run the same interpreter).

What goes by value follows cloudpickle's rule: a function or class that
cannot be imported by module and qualified name — a local function, a
lambda, a closure (with its cells), a local class, anything ``__main__``
defines — is rebuilt from its code and the globals its code names,
recursively; everything else (functions and classes of importable
modules, modules themselves, dataclasses' field sentinels) goes by
reference. Functions of one module share one globals dict per pickle, as
cloudpickle's do.

Tensors: a strided CPU tensor crosses as its bytes (its contiguous copy,
so strides are not kept; bf16 and every other dtype by its bit pattern)
in an out-of-band pickle-5 buffer with its dtype and shape, so with a
``buffer_callback`` a big one rides beside the payload like a numpy array
(the process pool puts such buffers in the shared-memory store). A CUDA
tensor crosses the same way, by value, and is rebuilt on the receiver's
own card, as the reference rebuilds a jax array on the receiver's default
device; a receiver that sees no card raises ``TypeError``.

``cluster/serialization.py`` builds the cluster's value pickles on this
pickler.
"""

from __future__ import annotations

import builtins
import dataclasses
import dis
import importlib
import io
import marshal
import pickle
import sys
import types
from typing import Callable, Optional

__all__ = ["CUDA_RULE", "Pickler", "by_reference", "dumps", "register_pickle_by_value"]

_GLOBAL_OPS = frozenset({"LOAD_GLOBAL", "STORE_GLOBAL", "DELETE_GLOBAL", "LOAD_NAME",
                         "STORE_NAME", "DELETE_NAME"})
# class attributes the interpreter makes for every class and a new class makes again
_CLASS_SKIP = frozenset({"__dict__", "__weakref__", "_abc_impl"})
_HEAPTYPE = 1 << 9  # Py_TPFLAGS_HEAPTYPE: the class was made by a class statement or type()

CUDA_RULE = ("a CUDA tensor crosses to another process by value and is rebuilt on the "
             "receiver's own card, but this process sees no card: a process-mode task "
             "that takes or returns CUDA tensors must hold 'GPU' (num_gpus > 0)")


class _EmptyCell:
    """Marks a closure cell that held no value when pickled."""


# modules whose functions and classes go by value although they import
# (cloudpickle.register_pickle_by_value): a test module, say, that the
# worker processes of a cluster cannot import
_BY_VALUE: set = set()


def register_pickle_by_value(module: types.ModuleType) -> None:
    """Pickle the functions and classes of ``module`` (and of its
    submodules) by value, as ``cloudpickle.register_pickle_by_value``."""
    _BY_VALUE.add(module.__name__)


def _registered_by_value(module_name: str) -> bool:
    return any(module_name == m or module_name.startswith(m + ".") for m in _BY_VALUE)


def by_reference(obj) -> bool:
    """cloudpickle's rule: ``obj`` (a function or class) is reached by
    importing its module, which is not ``__main__`` nor registered by
    value, and walking its qualified name to the very same object."""
    module_name = getattr(obj, "__module__", None)
    qualname = getattr(obj, "__qualname__", None)
    if not module_name or not qualname or module_name == "__main__":
        return False
    if _BY_VALUE and _registered_by_value(module_name):
        return False
    target = sys.modules.get(module_name)
    if target is None:
        return False
    for part in qualname.split("."):
        if part == "<locals>":
            return False
        target = getattr(target, part, None)
        if target is None:
            return False
    return target is obj


def _code_globals(code: types.CodeType, out: Optional[set] = None) -> set:
    """Names that ``code`` and the code nested in it look up as globals."""
    out = set() if out is None else out
    for ins in dis.get_instructions(code):
        if ins.opname in _GLOBAL_OPS:
            out.add(ins.argval)
    for const in code.co_consts:
        if isinstance(const, types.CodeType):
            _code_globals(const, out)
    return out


# -- reconstructors (module level: the unpickler finds them by name) ----------


def _load_code(data: bytes) -> types.CodeType:
    return marshal.loads(data)


def _make_function(code, base_globals: dict, name: str, ncells: int):
    base_globals.setdefault("__builtins__", builtins.__dict__)
    closure = tuple(types.CellType() for _ in range(ncells)) if ncells else None
    return types.FunctionType(code, base_globals, name, None, closure)


def _function_setstate(func, state: dict):
    func.__globals__.update(state["globals"])
    func.__defaults__ = state["defaults"]
    func.__kwdefaults__ = state["kwdefaults"]
    func.__qualname__ = state["qualname"]
    func.__module__ = state["module"]
    func.__doc__ = state["doc"]
    if state["dict"]:
        func.__dict__.update(state["dict"])
    for cell, value in zip(func.__closure__ or (), state["closure"] or ()):
        if value is not _EmptyCell:
            cell.cell_contents = value
    return func


def _make_class(meta, name: str, bases: tuple, namespace: dict):
    return meta(name, bases, dict(namespace))


def _class_setstate(cls, state: dict):
    for key, value in state.items():
        setattr(cls, key, value)
    return cls


def _make_mappingproxy(d: dict):
    return types.MappingProxyType(d)


def _rebuild_tensor(buf, dtype: str, shape: tuple, cuda: bool, requires_grad: bool,
                    parameter: bool):
    import torch

    if cuda and not torch.cuda.is_available():
        raise TypeError(CUDA_RULE)
    view = memoryview(buf)
    if view.nbytes == 0:
        flat = torch.empty(0, dtype=torch.uint8)
    else:
        # an inline buffer is read-only bytes: own a copy; a store view is
        # writable and aliased as numpy's out-of-band arrays are
        flat = torch.frombuffer(bytearray(view) if view.readonly else view, dtype=torch.uint8)
    t = flat.view(getattr(torch, dtype)).reshape(shape)
    if cuda:
        t = t.to("cuda")
    if parameter:
        return torch.nn.Parameter(t, requires_grad=requires_grad)
    return t.requires_grad_(requires_grad) if requires_grad else t


# -- the pickler ----------------------------------------------------------------


class Pickler(pickle.Pickler):
    """``pickle.Pickler`` that sends what cannot be imported by value and
    tensors as out-of-band bytes (see the module docstring)."""

    def __init__(self, file, protocol: int = 5, buffer_callback: Optional[Callable] = None):
        super().__init__(file, protocol=protocol, buffer_callback=buffer_callback)
        # one shared globals dict per module per pickle, as cloudpickle keeps
        self._base_globals: dict = {}

    def reducer_override(self, obj):
        if isinstance(obj, types.FunctionType):
            return NotImplemented if by_reference(obj) else self._function_reduce(obj)
        if isinstance(obj, type):
            # a class defined in Python (a heap type) that cannot be imported;
            # the interpreter's own types go by name as pickle sends them
            if not obj.__flags__ & _HEAPTYPE or by_reference(obj):
                return NotImplemented
            return self._class_reduce(obj)
        if isinstance(obj, types.CodeType):
            return _load_code, (marshal.dumps(obj),)
        if isinstance(obj, types.ModuleType):
            return _module_reduce(obj)
        if isinstance(obj, (staticmethod, classmethod)):
            return type(obj), (obj.__func__,)
        if isinstance(obj, property):
            return property, (obj.fget, obj.fset, obj.fdel, obj.__doc__)
        if obj is dataclasses.MISSING or obj is dataclasses.KW_ONLY:
            # the sentinels a by-value dataclass's fields hold, by name, so
            # ``field.default is MISSING`` still holds in the worker
            return "MISSING" if obj is dataclasses.MISSING else "KW_ONLY"
        if isinstance(obj, dataclasses._FIELD_BASE):
            return obj.name
        if isinstance(obj, types.MappingProxyType):  # a dataclass field's metadata
            return _make_mappingproxy, (dict(obj),)
        torch = sys.modules.get("torch")
        if torch is not None and isinstance(obj, torch.Tensor):
            return _tensor_reduce(torch, obj)
        return NotImplemented

    def _function_reduce(self, func: types.FunctionType):
        g = func.__globals__
        base = self._base_globals.get(id(g))
        if base is None:
            base = {k: g[k] for k in ("__name__", "__package__", "__file__") if k in g}
            self._base_globals[id(g)] = base
        names = _code_globals(func.__code__)
        closure = None
        if func.__closure__ is not None:
            closure = []
            for cell in func.__closure__:
                try:
                    closure.append(cell.cell_contents)
                except ValueError:  # an empty cell
                    closure.append(_EmptyCell)
        state = {
            "globals": {k: g[k] for k in sorted(names) if k in g},
            "defaults": func.__defaults__, "kwdefaults": func.__kwdefaults__,
            "qualname": func.__qualname__, "module": func.__module__, "doc": func.__doc__,
            "dict": dict(func.__dict__) or None, "closure": closure,
        }
        # the function exists (empty cells, bare globals) before its state
        # is pickled, so a state that reaches the function again (recursion
        # through a global or a cell) finds it in the memo
        return (_make_function, (func.__code__, base, func.__name__,
                                 len(func.__closure__ or ())),
                state, None, None, _function_setstate)

    def _class_reduce(self, cls: type):
        slots = cls.__dict__.get("__slots__", ())
        slots = (slots,) if isinstance(slots, str) else tuple(slots)
        namespace = {"__module__": cls.__module__, "__qualname__": cls.__qualname__}
        if "__slots__" in cls.__dict__:
            namespace["__slots__"] = slots
        state = {k: v for k, v in cls.__dict__.items()
                 if k not in _CLASS_SKIP and k not in namespace and k not in slots}
        return (_make_class, (type(cls), cls.__name__, cls.__bases__, namespace),
                state, None, None, _class_setstate)


def _module_reduce(module: types.ModuleType):
    name = module.__name__
    if name == "__main__" or sys.modules.get(name) is not module:
        raise pickle.PicklingError(f"module {name!r} cannot be imported by name in a worker")
    return importlib.import_module, (name,)


def _tensor_reduce(torch, t):
    if t.layout != torch.strided or t.is_quantized or t.device.type not in ("cpu", "cuda"):
        return NotImplemented
    requires_grad = t.requires_grad
    parameter = isinstance(t, torch.nn.Parameter)
    cuda = t.device.type == "cuda"
    host = t.detach().resolve_conj().resolve_neg()
    host = (host.cpu() if cuda else host).contiguous()
    raw = host.reshape(-1).view(torch.uint8).numpy()
    return (_rebuild_tensor, (pickle.PickleBuffer(raw), str(host.dtype).split(".")[-1],
                              tuple(host.shape), cuda, requires_grad, parameter))


def dumps(obj, protocol: int = 5, buffer_callback: Optional[Callable] = None) -> bytes:
    buf = io.BytesIO()
    Pickler(buf, protocol=protocol, buffer_callback=buffer_callback).dump(obj)
    return buf.getvalue()

