"""Runs a reference test module's unit classes against the port.

`swap(monkeypatch, ref_module)` rebinds, for one test, every name the
reference test module imports at its top level from
`image_analogies_tpu.*` to the same name in `image_analogies_tpu_torch.*`
(where the port has it).  A test file subclasses the reference's pure
unit classes and applies the swap in an autouse fixture, so the
reference's own test bodies run against the port's modules."""

import ast
import importlib
import inspect

_REF, _PORT = "image_analogies_tpu", "image_analogies_tpu_torch"


def port_names(ref_module):
    """{name in the reference test module: the port's object}."""
    out = {}
    tree = ast.parse(inspect.getsource(ref_module))
    for node in tree.body:
        if not (isinstance(node, ast.ImportFrom) and node.module
                and (node.module == _REF
                     or node.module.startswith(_REF + "."))):
            continue
        try:
            port_mod = importlib.import_module(
                _PORT + node.module[len(_REF):])
        except ImportError:
            continue
        for alias in node.names:
            obj = getattr(port_mod, alias.name, None)
            if obj is None:
                try:
                    obj = importlib.import_module(
                        f"{port_mod.__name__}.{alias.name}")
                except ImportError:
                    continue
            out[alias.asname or alias.name] = obj
    return out


def swap(monkeypatch, ref_module) -> None:
    for name, obj in port_names(ref_module).items():
        monkeypatch.setattr(ref_module, name, obj)
