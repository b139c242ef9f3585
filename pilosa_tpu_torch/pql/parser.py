"""PQL lexer, recursive-descent parser, and AST.

Behavioral parity with the reference (reference: pql/scanner.go:36-285,
pql/parser.go:45-260, pql/ast.go:27-241), re-written Python-idiomatically:
the lexer is a small regex-driven tokenizer instead of a rune state
machine, and the parser keeps the reference's semantics —

* identifiers: ``[A-Za-z][A-Za-z0-9_.-]*``
* numbers: optional leading ``-``, digits, at most one ``.`` (dot => float)
* strings: single- or double-quoted; escapes ``\\n \\\\ \\" \\'``;
  unterminated / newline / unknown escape are errors ("bad string")
* values: ``true``/``false``/``null`` (bare idents), ident, string,
  int, float, or a bracketed list of primitives
* children are parsed before keyword args; duplicate arg keys are errors
* canonical ``str()``: sorted arg keys, children first, Go-style quoting
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Any

# Go-style time layout used for string timestamps (reference: pql/parser.go:25)
TIME_FORMAT = "%Y-%m-%dT%H:%M"

# Mutating call names (reference: pql/ast.go:32-41)
WRITE_CALLS = frozenset({"SetBit", "ClearBit", "SetRowAttrs", "SetColumnAttrs"})


class ParseError(ValueError):
    def __init__(self, message: str, line: int = 0, char: int = 0):
        super().__init__(f"{message} at line {line}, char {char}")
        self.message = message
        self.line = line
        self.char = char


# --- tokenizer -------------------------------------------------------------

IDENT, STRING, INTEGER, FLOAT, LPAREN, RPAREN, LBRACK, RBRACK, COMMA, EQ, EOF = (
    "IDENT", "STRING", "INTEGER", "FLOAT", "(", ")", "[", "]", ",", "=", "EOF",
)
# Comparison token (BSI range predicates): lit holds the operator text.
CMP = "CMP"

# Comparison operators accepted between an argument key and its value
# (``Range(field > 100)``); ``><`` is the inclusive between operator.
# Longest-first so ``>=`` never lexes as ``>`` ``=``.
COMPARISON_OPS = ("><", ">=", "<=", "==", "!=", ">", "<")

_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<ident>[A-Za-z][A-Za-z0-9_.\-]*)
  | (?P<number>-?(?:\d+(?:\.\d*)?|\.\d+))
  | (?P<cmp>><|>=|<=|==|!=|>|<)
  | (?P<punct>[()\[\],=])
  | (?P<quote>["'])
    """,
    re.VERBOSE,
)

_ESCAPES = {"n": "\n", "\\": "\\", '"': '"', "'": "'"}


@dataclass
class _Token:
    kind: str
    lit: Any
    line: int
    char: int


def _tokenize(s: str) -> list[_Token]:
    tokens: list[_Token] = []
    pos = 0
    line, char = 0, 0

    def advance(text: str):
        nonlocal line, char
        nl = text.count("\n")
        if nl:
            line += nl
            char = len(text) - text.rfind("\n") - 1
        else:
            char += len(text)

    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if m is None:
            raise ParseError(f"illegal character {s[pos]!r}", line, char)
        start_line, start_char = line, char
        if m.lastgroup == "ws":
            advance(m.group())
            pos = m.end()
            continue
        if m.lastgroup == "ident":
            tokens.append(_Token(IDENT, m.group(), start_line, start_char))
        elif m.lastgroup == "number":
            lit = m.group()
            kind = FLOAT if "." in lit else INTEGER
            tokens.append(_Token(kind, lit, start_line, start_char))
        elif m.lastgroup == "cmp":
            tokens.append(_Token(CMP, m.group(), start_line, start_char))
        elif m.lastgroup == "punct":
            tokens.append(_Token(m.group(), m.group(), start_line, start_char))
        else:  # quoted string
            quote = m.group()
            buf = []
            i = m.end()
            while True:
                if i >= len(s) or s[i] == "\n":
                    raise ParseError("bad string", start_line, start_char)
                c = s[i]
                if c == quote:
                    i += 1
                    break
                if c == "\\":
                    if i + 1 >= len(s) or s[i + 1] not in _ESCAPES:
                        raise ParseError("bad string", start_line, start_char)
                    buf.append(_ESCAPES[s[i + 1]])
                    i += 2
                    continue
                buf.append(c)
                i += 1
            tokens.append(_Token(STRING, "".join(buf), start_line, start_char))
            advance(s[pos:i])
            pos = i
            continue
        advance(m.group())
        pos = m.end()
    tokens.append(_Token(EOF, "", line, char))
    return tokens


# --- AST -------------------------------------------------------------------


def _go_quote(v: str) -> str:
    """Go %q-style double-quoted string."""
    out = ['"']
    for c in v:
        if c == '"':
            out.append('\\"')
        elif c == "\\":
            out.append("\\\\")
        elif c == "\n":
            out.append("\\n")
        elif c == "\t":
            out.append("\\t")
        else:
            out.append(c)
    out.append('"')
    return "".join(out)


def _go_value(v: Any) -> str:
    """Go %v-style formatting for arg values."""
    if isinstance(v, bool):
        return "true" if v else "false"
    if v is None:
        # "null" (not Go's "%v" rendering "<nil>") so the canonical string
        # re-parses: remote forwarding ships str(query) as the wire format.
        return "null"
    if isinstance(v, str):
        return _go_quote(v)
    if isinstance(v, float):
        s = repr(v)
        return s[:-2] if s.endswith(".0") else s
    if isinstance(v, list):
        return "[" + ",".join(
            _go_quote(x) if isinstance(x, str) else _go_value(x) for x in v
        ) + "]"
    return str(v)


@dataclass(frozen=True)
class Cond:
    """A comparison-argument value: ``Range(field > 100)`` parses the
    ``field`` arg to ``Cond(op=">", value=100)``; ``field >< [a, b]``
    (inclusive between) carries a two-int list.  Canonical ``str()``
    renders ``key op value`` so BSI queries survive the remote-
    forwarding round trip (str -> parse) byte-identically."""

    op: str
    value: Any

    def render(self, key: str) -> str:
        return f"{key} {self.op} {_go_value(self.value)}"


@dataclass
class Call:
    """One function call node (reference: pql/ast.go:52-57)."""

    name: str
    args: dict[str, Any] = field(default_factory=dict)
    children: list["Call"] = field(default_factory=list)

    def uint_arg(self, key: str) -> int | None:
        """Read an integer argument; None when absent; TypeError when the
        value is not an integer (reference: Call.UintArg, pql/ast.go:64-77).
        Negative int64s wrap to uint64 like the reference's cast."""
        if key not in self.args:
            return None
        val = self.args[key]
        if isinstance(val, bool) or not isinstance(val, int):
            raise TypeError(
                f"could not convert {val!r} of type {type(val).__name__} to "
                f"uint64 in Call.uint_arg"
            )
        return val & 0xFFFFFFFFFFFFFFFF

    def uint_slice_arg(self, key: str) -> list[int] | None:
        """Read a list-of-integers argument (reference: Call.UintSliceArg,
        pql/ast.go:82-101)."""
        if key not in self.args:
            return None
        val = self.args[key]
        if not isinstance(val, list) or any(
            isinstance(v, bool) or not isinstance(v, int) for v in val
        ):
            raise TypeError(f"unexpected type in uint_slice_arg, val {val!r}")
        return [v & 0xFFFFFFFFFFFFFFFF for v in val]

    def clone(self) -> "Call":
        return Call(
            name=self.name,
            args=dict(self.args),
            children=[c.clone() for c in self.children],
        )

    def supports_inverse(self) -> bool:
        """reference: pql/ast.go:186-189"""
        return self.name in ("Bitmap", "TopN")

    def is_inverse(self, row_label: str, column_label: str) -> bool:
        """Inverse-view orientation detection (reference: pql/ast.go:191-211)."""
        if not self.supports_inverse():
            return False
        if self.name == "TopN":
            return self.args.get("inverse") is True
        try:
            row = self.uint_arg(row_label)
            col = self.uint_arg(column_label)
        except TypeError:
            return False
        return row is None and col is not None

    def conditions(self) -> dict[str, "Cond"]:
        """The comparison-valued args (BSI range predicates)."""
        return {k: v for k, v in self.args.items() if isinstance(v, Cond)}

    def __str__(self) -> str:
        parts = [str(c) for c in self.children]
        parts += [
            v.render(k) if isinstance(v, Cond) else f"{k}={_go_value(v)}"
            for k, v in sorted(self.args.items(), key=lambda kv: kv[0])
        ]
        return f"{self.name or '!UNNAMED'}({', '.join(parts)})"


@dataclass
class Query:
    """A parsed PQL query: a list of calls (reference: pql/ast.go:27-29)."""

    calls: list[Call] = field(default_factory=list)

    def write_call_n(self) -> int:
        """Number of mutating calls (reference: pql/ast.go:32-41)."""
        return sum(1 for c in self.calls if c.name in WRITE_CALLS)

    def __str__(self) -> str:
        return "\n".join(str(c) for c in self.calls)


# --- parser ----------------------------------------------------------------


class _Parser:
    def __init__(self, tokens: list[_Token]):
        self.tokens = tokens
        self.i = 0

    def peek(self, ahead: int = 0) -> _Token:
        return self.tokens[min(self.i + ahead, len(self.tokens) - 1)]

    def next(self) -> _Token:
        t = self.peek()
        if t.kind != EOF:
            self.i += 1
        return t

    def expect(self, kind: str) -> _Token:
        t = self.next()
        if t.kind != kind:
            raise ParseError(f"expected {kind}, found {t.lit!r}", t.line, t.char)
        return t

    def parse_query(self) -> Query:
        calls = []
        while self.peek().kind != EOF:
            calls.append(self.parse_call())
        if not calls:
            raise ParseError("unexpected EOF: query is empty", 0, 0)
        return Query(calls=calls)

    def parse_call(self) -> Call:
        t = self.next()
        if t.kind != IDENT:
            raise ParseError(f"expected identifier, found: {t.lit}", t.line, t.char)
        call = Call(name=t.lit)
        self.expect(LPAREN)

        # children first: lookahead IDENT + LPAREN means a nested call
        while self.peek().kind == IDENT and self.peek(1).kind == LPAREN:
            call.children.append(self.parse_call())
            t = self.peek()
            if t.kind == RPAREN:
                break
            if t.kind != COMMA:
                raise ParseError(
                    f"expected comma or right paren, found {t.lit!r}",
                    t.line, t.char,
                )
            self.next()

        # keyword arguments
        while self.peek().kind != RPAREN:
            t = self.next()
            if t.kind != IDENT:
                raise ParseError(
                    f"expected argument key, found {t.lit!r}", t.line, t.char
                )
            key = t.lit
            eq = self.next()
            if eq.kind == CMP:
                value = Cond(op=eq.lit, value=self.parse_value())
            elif eq.kind == EQ:
                value = self.parse_value()
            else:
                raise ParseError(
                    f"expected equals sign, found {eq.lit!r}", eq.line, eq.char
                )
            if key in call.args:
                raise ParseError(f"argument key already used: {key}", t.line, t.char)
            call.args[key] = value
            t = self.peek()
            if t.kind == RPAREN:
                break
            if t.kind != COMMA:
                raise ParseError(
                    f"expected comma or right paren, found {t.lit!r}",
                    t.line, t.char,
                )
            self.next()

        self.expect(RPAREN)
        return call

    def parse_value(self) -> Any:
        t = self.next()
        if t.kind == IDENT:
            if t.lit == "true":
                return True
            if t.lit == "false":
                return False
            if t.lit == "null":
                return None
            return t.lit
        if t.kind == STRING:
            return t.lit
        if t.kind == INTEGER:
            return int(t.lit)
        if t.kind == FLOAT:
            return float(t.lit)
        if t.kind == LBRACK:
            return self.parse_list()
        raise ParseError(f"invalid argument value: {t.lit!r}", t.line, t.char)

    def parse_list(self) -> list:
        """Bracketed list of primitives (reference: pql/parser.go:262-296;
        used by TopN filters)."""
        values = []
        while True:
            t = self.next()
            if t.kind == IDENT:
                if t.lit == "true":
                    values.append(True)
                elif t.lit == "false":
                    values.append(False)
                else:
                    values.append(t.lit)
            elif t.kind == STRING:
                values.append(t.lit)
            elif t.kind == INTEGER:
                values.append(int(t.lit))
            else:
                raise ParseError(f"invalid list value: {t.lit!r}", t.line, t.char)
            t = self.next()
            if t.kind == RBRACK:
                return values
            if t.kind != COMMA:
                raise ParseError(f"expected comma, found {t.lit!r}", t.line, t.char)


def parse_string(s: str) -> Query:
    """Parse a PQL string into a Query (reference: pql.ParseString,
    pql/parser.go:40-42)."""
    return _Parser(_tokenize(s)).parse_query()
