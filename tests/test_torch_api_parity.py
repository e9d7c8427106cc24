"""The port's public API against the JAX package's, name for name.

For every module of `linearsfm_tpu` (one case each): every public
function, class, method and NamedTuple or dataclass field has the same
name in the same module of `linearsfm_tpu_torch`, with the same parameter
names and kinds in the same order and the same default wherever the JAX
package gives one (`jnp.float64` equals `np.float64`, a dtype name equals
the torch dtype); the port may append only a keyword-only `device`.
Otherwise `linearsfm_tpu_torch/_parity.py` names the name, or the one
parameter that differs. Separate cases fail on a stale entry there and on
a counterpart that does not exist.
"""

import dataclasses
import importlib
import inspect
import os

import numpy as np
import pytest
import torch

import linearsfm_tpu
from linearsfm_tpu_torch._parity import PARITY

JAX, PORT = "linearsfm_tpu", "linearsfm_tpu_torch"
_EMPTY = inspect.Parameter.empty


def _modules() -> list[str]:
    """Every Python module of the JAX package, as a path under it."""
    root = os.path.dirname(linearsfm_tpu.__file__)
    out = []
    for d, dirs, files in os.walk(root):
        dirs[:] = sorted(x for x in dirs if not x.startswith("__"))
        for f in sorted(files):
            if f.endswith(".py"):
                rel = os.path.relpath(os.path.join(d, f[:-3]), root)
                rel = rel.replace(os.sep, ".").removesuffix("__init__")
                out.append(rel.rstrip("."))
    return out


MODULES = _modules()


def _import(pkg: str, rel: str):
    return importlib.import_module(f"{pkg}.{rel}" if rel else pkg)


def _public(mod) -> dict:
    """The functions and classes `mod` defines (decorated ones included)."""
    return {n: o for n, o in vars(mod).items()
            if not n.startswith("_") and callable(o)
            and getattr(o, "__module__", None) == mod.__name__}


def _fields(cls):
    """[(name, default)] of a NamedTuple or dataclass, else None."""
    if hasattr(cls, "_fields"):
        return [(f, cls._field_defaults.get(f, _EMPTY)) for f in cls._fields]
    if dataclasses.is_dataclass(cls):
        return [(f.name, _EMPTY if f.default is dataclasses.MISSING
                 else f.default) for f in dataclasses.fields(cls)]
    return None


def _param(path: str):
    """("X", "p") for "X(p)", else (path, None)."""
    if path.endswith(")"):
        base, p = path[:-1].split("(")
        return base, p
    return path, None


def _exempt(key: str) -> bool:
    """True where an entry answers for the whole object: one that names no
    parameter, in the JAX package or the port."""
    return key in PARITY and _param(PARITY[key][0] or "")[1] is None


def _param_entries(key: str):
    """The JAX parameters of `key` that the port leaves out, those it
    renames (JAX name -> port name) and the port's added ones."""
    drop, rename, added = set(), {}, set()
    for k, (where, _) in PARITY.items():
        base, p = _param(k)
        if base == key and p is not None:
            if where is None:
                drop.add(p)
            else:
                rename[p] = _param(where)[1]
        elif k == key and where is not None and _param(where)[1]:
            added.add(_param(where)[1])
    return drop, rename, added


def _dtype_name(v):
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    try:
        dt = np.dtype(v)
    except TypeError:
        return None
    return dt.name if dt.kind in "fiub" else None


def _same_default(a, b, where: str) -> list[str]:
    """Differences between the JAX default `a` and the port's `b`."""
    if a is _EMPTY:
        return []
    if hasattr(a, "_fields") and hasattr(b, "_fields"):
        mod = type(a).__module__.removeprefix(JAX + ".")
        cls = f"{mod}.{type(a).__name__}"
        out = []
        for f in a._fields:
            if f not in b._fields:
                if f"{cls}.{f}" not in PARITY:
                    out.append(f"{where}: default has no field {f}")
            else:
                out += _same_default(getattr(a, f), getattr(b, f),
                                     f"{where}.{f}")
        return out
    if isinstance(a, (str, type)) or isinstance(b, torch.dtype):
        na, nb = _dtype_name(a), _dtype_name(b)
        if na is not None and na == nb:
            return []
    if type(a) is type(b) and a == b:
        return []
    return [f"{where}: default {a!r} here, {b!r} in the port"]


def _same_params(fj, ft, where: str) -> list[str]:
    drop, rename, added = _param_entries(where)
    pj = [p.replace(name=rename.get(p.name, p.name))
          for p in inspect.signature(fj).parameters.values()
          if p.name not in drop]
    pt = [p for p in inspect.signature(ft).parameters.values()
          if p.name not in added]
    var = inspect.Parameter.VAR_KEYWORD
    kj = pj.pop() if pj and pj[-1].kind is var else None
    kt = pt.pop() if pt and pt[-1].kind is var else None
    if (len(pt) == len(pj) + 1 and pt[-1].name == "device"
            and pt[-1].kind is inspect.Parameter.KEYWORD_ONLY):
        pt.pop()
    pj += [kj] if kj else []
    pt += [kt] if kt else []
    sig = lambda ps: [(p.name, p.kind.name) for p in ps]  # noqa: E731
    if sig(pj) != sig(pt):
        return [f"{where}: parameters {sig(pj)} here, {sig(pt)} in the port"]
    out = []
    for a, b in zip(pj, pt):
        if a.default is not _EMPTY and b.default is _EMPTY:
            out.append(f"{where}({a.name}): no default in the port")
        else:
            out += _same_default(a.default, b.default, f"{where}({a.name})")
    return out


def _class_diffs(cj, ct, key: str) -> list[str]:
    out = []
    fj, ft = _fields(cj), _fields(ct)
    if fj is not None:
        names_t = [n for n, _ in ft or []]
        kept = [n for n, _ in fj if f"{key}.{n}" not in PARITY]
        for n, _ in fj:
            if n not in names_t and f"{key}.{n}" not in PARITY:
                out.append(f"{key}.{n}: no such field in the port")
        if [n for n in names_t if n in kept] != kept:
            out.append(f"{key}: fields {[n for n, _ in fj]} here, "
                       f"{names_t} in the port")
        dt = dict(ft or [])
        for n, d in fj:
            if n in dt:
                if d is not _EMPTY and dt[n] is _EMPTY:
                    out.append(f"{key}.{n}: no default in the port")
                else:
                    out += _same_default(d, dt[n], f"{key}.{n}")
    for n, m in vars(cj).items():
        if n.startswith("_") and n != "__init__":
            continue
        if n == "__init__" and (fj is not None or not inspect.isfunction(m)):
            continue
        k = f"{key}.{n}" if n != "__init__" else key
        if isinstance(m, property):
            if not isinstance(inspect.getattr_static(ct, n, None), property):
                out += [] if k in PARITY else [f"{k}: no such property"]
            continue
        if not isinstance(m, (staticmethod, classmethod)) and not callable(m):
            continue
        if _exempt(k):
            continue
        if n not in vars(ct) and not hasattr(ct, n):
            out.append(f"{k}: no such method in the port")
            continue
        out += _same_params(getattr(cj, n), getattr(ct, n), k)
    return out


def _params_of(obj, key: str) -> set[str]:
    """"key(p)" for each parameter p of a callable (a class: its
    constructor)."""
    obj = getattr(obj, "__func__", obj)
    try:
        return {f"{key}({p})" for p in inspect.signature(obj).parameters}
    except (TypeError, ValueError):
        return set()


def _diffs(rel: str) -> tuple[list[str], set[str]]:
    """(differences not named in PARITY, every key the module offers)."""
    mj = _import(JAX, rel)
    try:
        mt = _import(PORT, rel)
    except ModuleNotFoundError:
        mt = None
    pre = f"{rel}." if rel else ""
    out, keys = [], set()
    for n, o in _public(mj).items():
        key = pre + n
        keys.add(key)
        keys |= _params_of(o, key)
        if inspect.isclass(o):
            keys |= {f"{key}.{f}" for f, _ in _fields(o) or []}
            for m, mo in vars(o).items():
                if not m.startswith("_"):
                    keys.add(f"{key}.{m}")
                    keys |= _params_of(mo, f"{key}.{m}")
        if _exempt(key):
            continue
        ot = getattr(mt, n, None) if mt is not None else None
        if ot is None:
            out.append(f"{key}: not in the port")
        elif inspect.isclass(o):
            out += _class_diffs(o, ot, key)
        else:
            out += _same_params(o, ot, key)
    return out, keys


@pytest.mark.parametrize("rel", MODULES, ids=lambda r: r or "__init__")
def test_module_answers_the_jax_call_forms(rel):
    """Each public name of the module: the same call form in the port, or
    an entry of `_parity.PARITY`."""
    out, _ = _diffs(rel)
    assert not out, "\n".join(out)


def _module_of(key: str) -> str:
    parts = key.split(".")
    return next(r for r in (".".join(parts[:i])
                            for i in range(len(parts) - 1, -1, -1))
                if r in MODULES)


def test_parity_table_has_no_stale_entry():
    """Every entry names something of the JAX package that the port does
    not answer name for name, and gives a reason."""
    keys = set()
    for rel in MODULES:
        keys |= _diffs(rel)[1]
    stale = sorted(set(PARITY) - keys)
    assert not stale, f"entries naming nothing in {JAX}: {stale}"
    for k in sorted(PARITY):
        entry = PARITY.pop(k)
        try:
            out = _diffs(_module_of(k))[0]
        finally:
            PARITY[k] = entry
        base = _param(k)[0]
        assert any(line.startswith((base + ":", base + "(", base + "."))
                   for line in out), f"{k}: the port answers it name for name"
        why = entry[1]
        assert len(why) > 20 and why.strip(" .").lower() != "unnecessary", k


def _resolve(path: str):
    parts = path.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join([PORT] + parts[:i]))
        except ModuleNotFoundError:
            continue
        for p in parts[i:]:
            obj = getattr(obj, p)
        return obj
    raise ModuleNotFoundError(path)


def test_parity_counterparts_exist():
    """Each counterpart that `_parity.PARITY` names is in the port, and so
    is each parameter it names there."""
    for k, (where, _) in PARITY.items():
        if where is None:
            continue
        base, p = _param(where)
        obj = _resolve(base)
        assert callable(obj), (k, where)
        if p is not None:
            assert p in inspect.signature(obj).parameters, (k, where)
