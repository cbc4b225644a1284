"""SQLTransformer — SQL-style SELECT over a Table.

Member of the Flink ML 2.x feature surface (``feature/sqltransformer``;
the reference snapshot ships none — SURVEY §2.8).  The reference family
hands the statement to the host SQL engine with ``__THIS__`` standing for
the input table; this build has no SQL engine (and needs none: the Table
substrate is columnar numpy), so the statement is parsed into columnar
numpy expressions instead:

    SELECT <expr> [AS <name>], ... FROM __THIS__ [WHERE <cond>]

Supported in expressions: column names, literals, ``* `` for all columns,
arithmetic (+ - * / % **), comparisons, AND/OR/NOT, parentheses, and the
functions ABS, SQRT, EXP, LOG, LOG1P, SIN, COS, FLOOR, CEIL, ROUND, MIN,
MAX, POW, PLUS aggregate-free whole-column semantics (everything is
vectorized over rows).  Expressions are compiled through Python's ``ast``
with a strict whitelist — no attribute access, no calls outside the
function table, no names outside the column set — so a statement can
compute, it cannot reach into the process.

A port of the JAX package's ``models/feature/sqltransformer.py``: host
numpy, no ``device``; the ``ast`` whitelist, the function table and the
error texts are the JAX package's.
"""

from __future__ import annotations

import ast
import re
from typing import Any, Dict, List

import numpy as np

from ...api.stage import Transformer
from ...data.table import Table
from ...params.param import ParamValidators, StringParam

__all__ = ["SQLTransformer"]

_FUNCTIONS = {
    "abs": np.abs, "sqrt": np.sqrt, "exp": np.exp, "log": np.log,
    "log1p": np.log1p, "sin": np.sin, "cos": np.cos, "floor": np.floor,
    "ceil": np.ceil, "round": np.round, "min": np.minimum,
    "max": np.maximum, "pow": np.power,
}

_STATEMENT_RE = re.compile(
    r"^\s*select\s+(?P<select>.+?)\s+from\s+__THIS__\s*"
    r"(?:where\s+(?P<where>.+?)\s*)?$",
    re.IGNORECASE | re.DOTALL)

# SQL-isms normalised before ast-parsing as a Python expression.  All
# rewrites and the comma splitter run on a LITERAL-MASKED statement (see
# _mask_literals) so quoted strings are never corrupted.
_SQL_TO_PY = [
    (re.compile(r"(?<![<>!=])=(?!=)"), "=="),   # single = is equality
    (re.compile(r"<>"), "!="),
    (re.compile(r"\bAND\b", re.IGNORECASE), " and "),
    (re.compile(r"\bOR\b", re.IGNORECASE), " or "),
    (re.compile(r"\bNOT\b", re.IGNORECASE), " not "),
]

_LITERAL_RE = re.compile(r"'[^']*'")


def _mask_literals(statement: str):
    """Replace single-quoted literals with digit-only placeholders so the
    keyword/operator rewrites and the comma splitter cannot touch their
    contents; returns (masked, unmask_fn)."""
    literals: List[str] = []

    def stash(match):
        literals.append(match.group(0))
        return f"\x00{len(literals) - 1}\x00"

    masked = _LITERAL_RE.sub(stash, statement)

    def unmask(text: str) -> str:
        return re.sub(r"\x00(\d+)\x00",
                      lambda m: literals[int(m.group(1))], text)

    return masked, unmask

_ALLOWED_NODES = (
    ast.Expression, ast.BinOp, ast.UnaryOp, ast.BoolOp, ast.Compare,
    ast.Call, ast.Name, ast.Constant, ast.Load,
    ast.Add, ast.Sub, ast.Mult, ast.Div, ast.Mod, ast.Pow,
    ast.USub, ast.UAdd, ast.Not, ast.And, ast.Or,
    ast.Eq, ast.NotEq, ast.Lt, ast.LtE, ast.Gt, ast.GtE,
)


def _check_ast(tree: ast.AST, columns) -> None:
    for node in ast.walk(tree):
        if not isinstance(node, _ALLOWED_NODES):
            raise ValueError(
                f"unsupported syntax in SQLTransformer statement: "
                f"{type(node).__name__}")
        if isinstance(node, ast.Call):
            if not isinstance(node.func, ast.Name) \
                    or node.func.id.lower() not in _FUNCTIONS:
                raise ValueError(
                    "unknown function in SQLTransformer statement"
                    + (f": {node.func.id!r}"
                       if isinstance(node.func, ast.Name) else ""))
            if node.keywords:
                raise ValueError("keyword arguments are not supported")
        elif isinstance(node, ast.Name):
            if node.id not in columns \
                    and node.id.lower() not in _FUNCTIONS:
                raise ValueError(
                    f"unknown column {node.id!r}; available: "
                    f"{sorted(columns)}")


class _Evaluator(ast.NodeVisitor):
    def __init__(self, columns: Dict[str, np.ndarray]):
        self.columns = columns

    def visit_Expression(self, node):
        return self.visit(node.body)

    def visit_Constant(self, node):
        return node.value

    def visit_Name(self, node):
        if node.id in self.columns:
            return self.columns[node.id]
        return _FUNCTIONS[node.id.lower()]

    def visit_Call(self, node):
        fn = _FUNCTIONS[node.func.id.lower()]
        return fn(*[self.visit(a) for a in node.args])

    def visit_BinOp(self, node):
        left, right = self.visit(node.left), self.visit(node.right)
        op = type(node.op)
        if op is ast.Add:
            return left + right
        if op is ast.Sub:
            return left - right
        if op is ast.Mult:
            return left * right
        if op is ast.Div:
            return left / right
        if op is ast.Mod:
            return left % right
        return left ** right          # ast.Pow (whitelist-bounded)

    def visit_UnaryOp(self, node):
        val = self.visit(node.operand)
        if isinstance(node.op, ast.USub):
            return -val
        if isinstance(node.op, ast.Not):
            return np.logical_not(val)
        return val                     # UAdd

    def visit_BoolOp(self, node):
        vals = [np.asarray(self.visit(v), bool) for v in node.values]
        out = vals[0]
        for v in vals[1:]:
            out = (out & v) if isinstance(node.op, ast.And) else (out | v)
        return out

    def visit_Compare(self, node):
        left = self.visit(node.left)
        out = None
        for op, comp in zip(node.ops, node.comparators):
            right = self.visit(comp)
            op_t = type(op)
            if op_t is ast.Eq:
                res = left == right
            elif op_t is ast.NotEq:
                res = left != right
            elif op_t is ast.Lt:
                res = left < right
            elif op_t is ast.LtE:
                res = left <= right
            elif op_t is ast.Gt:
                res = left > right
            else:
                res = left >= right
            out = res if out is None else (out & res)
            left = right
        return out


def _split_select_list(select: str) -> List[str]:
    """Split on top-level commas (not inside parentheses)."""
    parts, depth, start = [], 0, 0
    for i, ch in enumerate(select):
        if ch == "(":
            depth += 1
        elif ch == ")":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(select[start:i].strip())
            start = i + 1
    parts.append(select[start:].strip())
    return [p for p in parts if p]


_AS_RE = re.compile(r"^(?P<expr>.+?)\s+as\s+(?P<name>[A-Za-z_]\w*)\s*$",
                    re.IGNORECASE | re.DOTALL)


class SQLTransformer(Transformer):
    STATEMENT = StringParam(
        "statement",
        "SELECT <expr> [AS <name>], ... FROM __THIS__ [WHERE <cond>].",
        default=None, validator=ParamValidators.not_null())

    def get_statement(self) -> str:
        return self.get(SQLTransformer.STATEMENT)

    def set_statement(self, value: str):
        return self.set(SQLTransformer.STATEMENT, value)

    @staticmethod
    def _eval(expr: str, columns: Dict[str, np.ndarray],
              unmask=None) -> Any:
        for pattern, repl in _SQL_TO_PY:
            expr = pattern.sub(repl, expr)
        if unmask is not None:
            expr = unmask(expr)
        try:
            tree = ast.parse(expr.strip(), mode="eval")
        except SyntaxError as exc:
            raise ValueError(
                f"SQLTransformer could not parse expression {expr!r}: "
                f"{exc.msg}") from exc
        _check_ast(tree, columns.keys())
        return _Evaluator(columns).visit(tree)

    def transform(self, *inputs) -> List[Table]:
        (table,) = inputs
        masked, unmask = _mask_literals(self.get_statement())
        match = _STATEMENT_RE.match(masked)
        if not match:
            raise ValueError(
                "SQLTransformer statement must be of the form "
                "'SELECT ... FROM __THIS__ [WHERE ...]' "
                f"(got {self.get_statement()!r})")
        columns = table.to_dict()

        where = match.group("where")
        if where:
            mask = np.asarray(self._eval(where, columns, unmask), bool)
            if mask.ndim != 1 or mask.shape[0] != table.num_rows:
                raise ValueError("WHERE clause must produce one boolean "
                                 "per row")
            columns = {n: c[mask] for n, c in columns.items()}

        out: Dict[str, np.ndarray] = {}
        n_rows = next(iter(columns.values())).shape[0] if columns else 0
        for i, item in enumerate(_split_select_list(match.group("select"))):
            if item == "*":
                out.update(columns)
                continue
            as_match = _AS_RE.match(item)
            expr = as_match.group("expr") if as_match else item
            name = (as_match.group("name") if as_match
                    else (expr if re.fullmatch(r"[A-Za-z_]\w*", expr)
                          else f"col{i}"))
            value = self._eval(expr, columns, unmask)
            value = np.asarray(value)
            if value.ndim == 0:        # scalar literal: broadcast
                value = np.full((n_rows,), value)
            out[name] = value
        return [Table(out)]
