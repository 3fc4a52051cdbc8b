"""Dtype discipline on the transfer boundary.

``PLANE_SCHEMA`` is the declared plane registry: every packed plane the
delta-pack / streaming-pack / arena layer materializes, with its
contract dtype (as a *string* — this package never imports numpy or
torch).  The pass checks, in ``ops/packing.py``, ``ops/stream_pack.py``,
``cache/arena.py`` and the CUDA launchers' ``kernels/__init__.py``:

- ``dtype-less``     numpy array creations with no explicit dtype, and
                     ``torch.zeros`` / ``empty`` / ``full`` / ``tensor``
                     / ``as_tensor`` / ``arange`` with no ``dtype=``
                     (the silent int64/float64 or float32 default
                     defeats tightening and doubles transfer bytes)
- ``platform-dtype`` explicit bare ``int``/``float`` dtypes (width
                     depends on the platform; ``torch.int`` and
                     ``torch.float`` are int32 and float32)
- ``schema-mismatch``a literal plane name created/ensured with a dtype
                     other than its registered one, or a launcher's
                     argument check ``_check("<plane>", t, <dtype>,
                     ...)`` of a registered plane asking for another
                     dtype than the schema's
- ``unknown-plane``  a literal plane name absent from the schema

A dtype named through a local alias (``i32, b = torch.int32,
torch.bool`` in the function or at module level) is resolved to what it
names.
"""

from __future__ import annotations

import ast
from typing import Optional

from .core import Context, Finding, ParsedFile, dotted

RULE = "dtype"

_SCOPE_SUFFIXES = ("ops/packing.py", "ops/stream_pack.py", "cache/arena.py",
                   "kernels/__init__.py")

#: plane name -> contract dtype string.  Row planes (streamed grids),
#: the per-CQ usage plane, and the int32 structure planes that
#: ``TIGHTEN_PLANES`` is allowed to narrow.
PLANE_SCHEMA: dict[str, str] = {
    # streamed row planes (_ROW_PLANES)
    "wl_req": "int32", "wl_rank": "int32", "wl_cycle_rank": "int32",
    "wl_prio": "int32", "wl_uidrank": "int32",
    "vec_ok": "bool", "elig0": "bool", "parked0": "bool",
    "resume0": "int32", "adm0": "bool", "adm_seq0": "int32",
    "adm_usage0": "int32", "adm_uses0": "bool", "death0": "int32",
    # arena extras
    "u_cq0": "int32", "keys_grid": "object",
    # cohort-forest aggregate planes (ops/aggregate.py)
    "agg_heads": "int32", "agg_rows": "int32", "agg_comp": "int32",
    "agg_comp_ts": "float64", "agg_best_prio": "int32",
    "agg_best_ts": "float64",
    # tightenable structure planes
    "parent": "int32", "node_level": "int32", "nominal_cq": "int32",
    "slot_fr": "int32", "forest_of_cq": "int32", "members": "int32",
    "cand_rows": "int32", "cand_lmem": "int32", "self_lmem": "int32",
}

#: planes tighten_arrays() may narrow — must be int32 in the schema
TIGHTENABLE = ("wl_req", "wl_cycle_rank", "wl_prio", "wl_uidrank",
               "parent", "node_level", "nominal_cq", "slot_fr",
               "forest_of_cq", "members", "cand_rows", "cand_lmem",
               "self_lmem")

_CREATORS = {"zeros": 1, "ones": 1, "empty": 1, "full": 2,
             "asarray": 1, "array": 1, "arange": None, "fromiter": 1,
             "frombuffer": None}
#: torch creators -> the position a dtype may take (None: keyword only)
_TORCH_CREATORS = {"zeros": None, "empty": None, "full": None,
                   "tensor": None, "as_tensor": 1, "arange": None}
#: torch's dtype aliases -> the width they name
_TORCH_ALIASES = {"long": "int64", "int": "int32", "short": "int16",
                  "float": "float32", "double": "float64",
                  "half": "float16"}


def _aliases_of(index, names: tuple) -> set[str]:
    out = set()
    for node in index.of(ast.Import):
        for a in node.names:
            if a.name in names:
                out.add(a.asname or a.name.split(".")[0])
    return out


def _np_aliases(index) -> set[str]:
    return _aliases_of(index, ("numpy", "jax.numpy"))


def _dtype_str(node: Optional[ast.AST], torch_names=(),
               aliases: Optional[dict] = None) -> Optional[str]:
    """Resolve a dtype expression to a string, or None if dynamic; a
    Name bound in ``aliases`` resolves to the expression it names."""
    if node is None:
        return None
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    if isinstance(node, ast.Name):
        if aliases and node.id in aliases:
            return _dtype_str(aliases[node.id], torch_names)
        return node.id if node.id in ("bool", "object", "int",
                                      "float", "complex") else None
    d = dotted(node)
    if d and "." in d:
        tail = d.split(".")[-1]
        if d.split(".")[0] in torch_names and tail in _TORCH_ALIASES:
            return _TORCH_ALIASES[tail]
        if tail.startswith(("int", "uint", "float", "bool", "complex")) \
                or tail in ("object_",):
            return tail.rstrip("_")
    return None


def _bindings(index, scope: ast.AST) -> dict:
    """Name -> expression for the simple and tuple assignments of one
    scope's own statements (nested defs excluded), kept in the index's
    ``memo`` once found."""
    memo = index.memo
    if ("bindings", scope) in memo:
        return memo["bindings", scope]
    out: dict = {}
    stack = list(scope.body)
    while stack:
        node = stack.pop(0)
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Assign) and len(node.targets) == 1:
            t, v = node.targets[0], node.value
            if isinstance(t, ast.Name):
                out[t.id] = v
            elif (isinstance(t, ast.Tuple) and isinstance(v, ast.Tuple)
                  and len(t.elts) == len(v.elts)):
                for te, ve in zip(t.elts, v.elts):
                    if isinstance(te, ast.Name):
                        out[te.id] = ve
        stack.extend(index.children(node))
    memo["bindings", scope] = out
    return out


def _aliases_at(index, funcs, lineno: int) -> dict:
    """The bindings visible at a line: the module's, then each enclosing
    def's, inner ones last (they shadow)."""
    out = dict(_bindings(index, index.tree))
    scopes = [info.node for info in funcs.values()
              if info.node.lineno <= lineno
              <= getattr(info.node, "end_lineno", info.node.lineno)]
    for n in sorted(scopes, key=lambda n: n.lineno):
        out.update(_bindings(index, n))
    return out


def _creation_dtype(call: ast.Call, pos: Optional[int]):
    """(dtype node or None, explicitly-given?) for a creation call."""
    for kw in call.keywords:
        if kw.arg == "dtype":
            return kw.value, True
    if pos is not None and len(call.args) > pos:
        return call.args[pos], True
    return None, False


def _enclosing(funcs, lineno: int) -> str:
    best = ""
    for info in funcs.values():
        n = info.node
        if n.lineno <= lineno and (getattr(n, "end_lineno", n.lineno)
                                   >= lineno):
            if len(info.qualname) > len(best):
                best = info.qualname
    return best


def run(files: list[ParsedFile], ctx: Context) -> list[Finding]:
    out: list[Finding] = []
    for pf in files:
        if not pf.path.endswith(_SCOPE_SUFFIXES):
            continue
        index = pf.index
        np_names = _np_aliases(index)
        torch_names = _aliases_of(index, ("torch",))
        funcs = index.functions()

        def dtype_of(node, at):
            return _dtype_str(node, torch_names,
                              _aliases_at(index, funcs, at.lineno))

        def emit(code, node, msg):
            out.append(Finding(RULE, code, pf.path, node.lineno,
                               _enclosing(funcs, node.lineno), msg))

        for node in index.of(ast.Call, ast.Assign):
            # --- creation calls -------------------------------------
            if isinstance(node, ast.Call):
                d = dotted(node.func)
                if (d and d.split(".")[0] in np_names
                        and d.split(".")[-1] in _CREATORS
                        and len(d.split(".")) == 2):
                    fn = d.split(".")[-1]
                    dt_node, given = _creation_dtype(node, _CREATORS[fn])
                    if not given:
                        emit("dtype-less", node,
                             f"`{d}()` without an explicit dtype: the "
                             "int64/float64 default defeats tightening")
                    elif _dtype_str(dt_node) in ("int", "float"):
                        emit("platform-dtype", node,
                             f"`{d}(dtype={_dtype_str(dt_node)})`: bare "
                             "`int`/`float` width is platform-dependent")
                elif (d and d.split(".")[0] in torch_names
                        and d.split(".")[-1] in _TORCH_CREATORS
                        and len(d.split(".")) == 2):
                    fn = d.split(".")[-1]
                    dt_node, given = _creation_dtype(node,
                                                     _TORCH_CREATORS[fn])
                    if not given:
                        emit("dtype-less", node,
                             f"`{d}()` without `dtype=`: torch's "
                             "int64/float32 default defeats tightening")
                    elif dtype_of(dt_node, node) in ("int", "float"):
                        emit("platform-dtype", node,
                             f"`{d}(dtype={dtype_of(dt_node, node)})`: "
                             "bare `int`/`float` width is "
                             "platform-dependent")
                elif (dotted(node.func) in ("_check", "kernels._check")
                      and len(node.args) >= 3
                      and isinstance(node.args[0], ast.Constant)
                      and node.args[0].value in PLANE_SCHEMA):
                    # a launcher's argument check: kernels._check(name,
                    # t, dtype, shape, device)
                    name = node.args[0].value
                    want = PLANE_SCHEMA[name]
                    got = dtype_of(node.args[2], node)
                    if got is not None and got != want:
                        emit("schema-mismatch", node,
                             f"launcher checks plane `{name}` as {got}, "
                             f"schema says {want}")
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "astype" and node.args):
                    if _dtype_str(node.args[0]) in ("int", "float"):
                        emit("platform-dtype", node,
                             "`.astype(int/float)`: width is "
                             "platform-dependent")
                elif (isinstance(node.func, ast.Attribute)
                      and node.func.attr == "ensure"):
                    # arena.ensure(name, shape, dtype, fill, ...)
                    name = None
                    if node.args:
                        c = node.args[0]
                        if isinstance(c, ast.Constant) and \
                                isinstance(c.value, str):
                            name = c.value
                    if name is not None:
                        want = PLANE_SCHEMA.get(name)
                        if want is None:
                            emit("unknown-plane", node,
                                 f"arena.ensure of undeclared plane "
                                 f"`{name}` (add it to PLANE_SCHEMA)")
                        else:
                            got = _dtype_str(node.args[2]) \
                                if len(node.args) > 2 else None
                            if got is not None and got != want:
                                emit("schema-mismatch", node,
                                     f"plane `{name}` ensured as {got}, "
                                     f"schema says {want}")
            # --- the _ROW_PLANES declaration itself -----------------
            elif (isinstance(node, ast.Assign)
                  and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Name)
                  and node.targets[0].id == "_ROW_PLANES"
                  and isinstance(node.value, ast.Dict)):
                for k, v in zip(node.value.keys, node.value.values):
                    if not (isinstance(k, ast.Constant)
                            and isinstance(v, (ast.Tuple, ast.List))
                            and len(v.elts) >= 2):
                        continue
                    name = k.value
                    want = PLANE_SCHEMA.get(name)
                    got = _dtype_str(v.elts[1])
                    if want is None:
                        emit("unknown-plane", k,
                             f"row plane `{name}` not in PLANE_SCHEMA")
                    elif got is not None and got != want:
                        emit("schema-mismatch", k,
                             f"row plane `{name}` declared {got}, "
                             f"schema says {want}")
            # --- TIGHTEN_PLANES names must be tightenable int32 -----
            elif (isinstance(node, ast.Assign)
                  and len(node.targets) == 1
                  and isinstance(node.targets[0], ast.Name)
                  and node.targets[0].id == "TIGHTEN_PLANES"
                  and isinstance(node.value, (ast.Tuple, ast.List))):
                for elt in node.value.elts:
                    if not (isinstance(elt, ast.Constant)
                            and isinstance(elt.value, str)):
                        continue
                    want = PLANE_SCHEMA.get(elt.value)
                    if want is None:
                        emit("unknown-plane", elt,
                             f"TIGHTEN_PLANES entry `{elt.value}` not in "
                             "PLANE_SCHEMA")
                    elif want != "int32":
                        emit("schema-mismatch", elt,
                             f"TIGHTEN_PLANES entry `{elt.value}` is "
                             f"{want} in the schema; only int32 planes "
                             "tighten")
    return out
