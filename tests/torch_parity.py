"""Run test cases of the JAX package's own test modules against the PyTorch
port as well, and compare what each package did.

``load(name, port)`` executes ``tests/<name>.py`` as a fresh module, as it
is (``port=False``) or with every ``lambdaworks_cairo_prover_tpu`` import
pointing at ``lambdaworks_cairo_prover_tpu_torch`` (``port=True``).  The
test modules themselves are not changed.  ``run_case`` runs one test
function of such a module, records every ``CairoVM`` it makes, and returns
the outcome (passed, or the exception's type and message) together with the
final state of those VMs: memory segments, hint scopes and ecdsa
signatures, with relocatable values and helper objects reduced to plain
data.  A parity test requires equal results from both packages.

Only host-side cases belong here (VM, hints, builtins): a case that proves
would compile the JAX prover for minutes."""

from __future__ import annotations

import functools
import importlib
import os
import re
import types

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
JAX_PKG = "lambdaworks_cairo_prover_tpu"
PORT_PKG = "lambdaworks_cairo_prover_tpu_torch"


@functools.lru_cache(maxsize=None)
def load(name: str, port: bool) -> types.ModuleType:
    path = os.path.join(HERE, f"{name}.py")
    with open(path) as f:
        src = f.read()
    if port:
        src = re.sub(rf"\b{JAX_PKG}\b", PORT_PKG, src)
    mod = types.ModuleType(f"{name}__{'port' if port else 'jax'}")
    mod.__file__ = path
    exec(compile(src, path, "exec"), mod.__dict__)
    return mod


def cases(name: str, only=None, exclude=()) -> list[tuple[str, str, dict]]:
    """(module name, test function name, keyword arguments) for every test
    function of ``tests/<name>.py`` (or those in ``only``), one entry per
    value of a single ``pytest.mark.parametrize``."""
    mod = load(name, False)
    out = []
    for fname, fn in vars(mod).items():
        if not fname.startswith("test_") or not callable(fn):
            continue
        if (only is not None and fname not in only) or fname in exclude:
            continue
        marks = [m for m in getattr(fn, "pytestmark", [])
                 if m.name == "parametrize"]
        if not marks:
            out.append((name, fname, {}))
            continue
        (mark,) = marks
        argnames, values = mark.args[0], mark.args[1]
        names = [a.strip() for a in argnames.split(",")]
        for v in values:
            vals = v if len(names) > 1 else (v,)
            out.append((name, fname, dict(zip(names, vals))))
    return out


def case_id(case: tuple[str, str, dict]) -> str:
    name, fname, kwargs = case
    text = f"{name[len('test_'):]}.{fname[len('test_'):]}"
    if kwargs:
        text += "-" + "-".join(repr(v)[:16] for v in kwargs.values())
    return text


def _message(exc: BaseException) -> str:
    text = str(exc).replace(PORT_PKG, JAX_PKG)
    return re.sub(r" at 0x[0-9a-f]+", "", text)


def plain(value, _depth: int = 0):
    """``value`` as comparable plain data: relocatables as ("rel", segment,
    offset), objects as (class name, their attributes)."""
    if _depth > 12:
        return "..."
    d = _depth + 1
    if value is None or isinstance(value, (bool, int, str, bytes, float)):
        return value
    if type(value).__name__ == "Relocatable":
        return ("rel", value.segment, value.offset)
    if isinstance(value, dict):
        return sorted(((repr(plain(k, d)), plain(v, d))
                       for k, v in value.items()), key=lambda kv: kv[0])
    if isinstance(value, (list, tuple)):
        return [plain(v, d) for v in value]
    if isinstance(value, (set, frozenset)):
        return sorted(repr(plain(v, d)) for v in value)
    if isinstance(value, range):
        return ("range", value.start, value.stop)
    if isinstance(value, (types.FunctionType, types.MethodType)):
        return ("function", value.__qualname__)
    if hasattr(value, "__dict__"):
        return (type(value).__name__, plain(vars(value), d))
    return (type(value).__name__, repr(value))


def vm_state(vm) -> dict:
    return {"segments": plain(vm.segments),
            "exec_scopes": plain(vm.exec_scopes),
            "signatures": plain(vm.signatures),
            "builtin_bases": plain(vm.builtin_bases)}


def run_case(name: str, port: bool, fname: str, kwargs: dict):
    """(outcome, states of the VMs the case made) of one test case.  Every
    ``CairoVM`` that the package builds while the case runs is recorded,
    whether the case calls the class itself or reaches it through
    ``run_program``, the runner or the CASM entry point."""
    mod = load(name, port)
    cls = importlib.import_module(
        f"{PORT_PKG if port else JAX_PKG}.cairo.vm").CairoVM
    made = []
    init = cls.__init__

    def recording(self, *args, **kw):
        init(self, *args, **kw)
        made.append(self)

    cls.__init__ = recording
    try:
        getattr(mod, fname)(**kwargs)
        outcome = "passed"
    except (Exception, pytest.fail.Exception) as exc:
        # an assertion, a VM or hint error, or a failed pytest.raises
        outcome = (type(exc).__name__, _message(exc))
    finally:
        cls.__init__ = init
    return outcome, [vm_state(vm) for vm in made]


def check_case(case: tuple[str, str, dict], known_failing=(), no_vm=()):
    """Run ``case`` in both packages and require equal outcomes and VM
    states.  The JAX package must pass the case, unless its function name
    is in ``known_failing``; it must build at least one VM, unless its
    function name is in ``no_vm`` (cases of plain functions)."""
    name, fname, kwargs = case
    want = run_case(name, False, fname, kwargs)
    if fname in known_failing:
        assert want[0] != "passed", f"{fname} passes now: update the list"
    else:
        assert want[0] == "passed", want[0]
    if fname in no_vm:
        assert not want[1], f"{fname} builds a VM now: update the list"
    else:
        assert want[1], f"{fname} built no CairoVM"
    assert run_case(name, True, fname, kwargs) == want
