"""SQL tokenizer.

Written from scratch (the environment has no SQL parsing library). Plays the
role sqlparser-rs plays for the reference (`datafusion/sql/src/parser.rs:299`
wraps it). Produces a flat token stream consumed by the Pratt parser in
``parser.py``.
"""
from __future__ import annotations

import dataclasses
import enum
from typing import List, Optional

from ..common.errors import ParserError


class Tok(enum.Enum):
    WORD = "word"          # keyword or identifier (value = upper-cased text)
    IDENT = "ident"        # quoted identifier, case preserved
    NUMBER = "number"
    STRING = "string"      # single-quoted string literal
    OP = "op"              # operator / punctuation
    PARAM = "param"        # $1 placeholders
    EOF = "eof"


@dataclasses.dataclass
class Token:
    kind: Tok
    value: str
    raw: str
    pos: int

    def __repr__(self):
        return f"{self.kind.name}({self.value!r})"


_MULTI_OPS = ["<=>", "<>", "<=", ">=", "!=", "||", "::", "->>", "->",
              "!~~*", "!~~", "~~*", "~~", "~*", "!~*", "!~", "<<", ">>",
              "=="]
_SINGLE_OPS = set("+-*/%(),.;<>=~[]{}:&|^!?@#")


def tokenize(sql: str) -> List[Token]:
    toks: List[Token] = []
    i, n = 0, len(sql)
    while i < n:
        c = sql[i]
        # whitespace
        if c.isspace():
            i += 1
            continue
        # comments
        if c == "-" and i + 1 < n and sql[i + 1] == "-":
            j = sql.find("\n", i)
            i = n if j < 0 else j + 1
            continue
        if c == "/" and i + 1 < n and sql[i + 1] == "*":
            j = sql.find("*/", i + 2)
            if j < 0:
                raise ParserError(f"unterminated block comment at {i}")
            i = j + 2
            continue
        # string literal (with '' escape)
        if c == "'":
            j = i + 1
            buf = []
            while True:
                if j >= n:
                    raise ParserError(f"unterminated string literal at {i}")
                if sql[j] == "'":
                    if j + 1 < n and sql[j + 1] == "'":
                        buf.append("'")
                        j += 2
                        continue
                    break
                buf.append(sql[j])
                j += 1
            toks.append(Token(Tok.STRING, "".join(buf), sql[i:j + 1], i))
            i = j + 1
            continue
        # E'...' style
        if c in ("e", "E") and i + 1 < n and sql[i + 1] == "'":
            j = i + 2
            buf = []
            while j < n and sql[j] != "'":
                if sql[j] == "\\" and j + 1 < n:
                    esc = sql[j + 1]
                    buf.append({"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(sql[j])
                    j += 1
            toks.append(Token(Tok.STRING, "".join(buf), sql[i:j + 1], i))
            i = j + 1
            continue
        # quoted identifiers
        if c == '"' or c == "`":
            close = c
            j = sql.find(close, i + 1)
            if j < 0:
                raise ParserError(f"unterminated quoted identifier at {i}")
            toks.append(Token(Tok.IDENT, sql[i + 1:j], sql[i:j + 1], i))
            i = j + 1
            continue
        # numbers
        if c.isdigit() or (c == "." and i + 1 < n and sql[i + 1].isdigit()):
            j = i
            seen_dot = False
            seen_e = False
            while j < n:
                ch = sql[j]
                if ch.isdigit():
                    j += 1
                elif ch == "." and not seen_dot and not seen_e:
                    seen_dot = True
                    j += 1
                elif ch in "eE" and not seen_e and j + 1 < n and (sql[j + 1].isdigit() or sql[j + 1] in "+-"):
                    seen_e = True
                    j += 2 if sql[j + 1] in "+-" else 1
                else:
                    break
            toks.append(Token(Tok.NUMBER, sql[i:j], sql[i:j], i))
            i = j
            continue
        # parameters
        if c == "$" and i + 1 < n and sql[i + 1].isdigit():
            j = i + 1
            while j < n and sql[j].isdigit():
                j += 1
            toks.append(Token(Tok.PARAM, sql[i + 1:j], sql[i:j], i))
            i = j
            continue
        # words
        if c.isalpha() or c == "_":
            j = i
            while j < n and (sql[j].isalnum() or sql[j] == "_"):
                j += 1
            raw = sql[i:j]
            toks.append(Token(Tok.WORD, raw.upper(), raw, i))
            i = j
            continue
        # multi-char operators
        matched = False
        for op in _MULTI_OPS:
            if sql.startswith(op, i):
                # `==` is an accepted spelling of `=` (reference: sqlparser)
                toks.append(Token(Tok.OP, "=" if op == "==" else op, op, i))
                i += len(op)
                matched = True
                break
        if matched:
            continue
        if c in _SINGLE_OPS:
            toks.append(Token(Tok.OP, c, c, i))
            i += 1
            continue
        raise ParserError(f"unexpected character {c!r} at position {i}")
    toks.append(Token(Tok.EOF, "", "", n))
    return toks
