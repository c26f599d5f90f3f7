"""SQL lexer — regex scanner (copy of tidb_tpu/parser/lexer.py; ref: pingcap/parser lexer.go, fresh design)."""

from __future__ import annotations

import re
from dataclasses import dataclass

from ..errors import ParseError

TOKEN_RE = re.compile(
    r"""
    (?P<hint>/\*\+.*?\*/)
  | (?P<ws>\s+|\#[^\n]*|--\s[^\n]*|/\*.*?\*/)
  | (?P<hex>0[xX][0-9a-fA-F]+|[xX]'[0-9a-fA-F]*')
  | (?P<num>(\d+\.\d*|\.\d+|\d+)([eE][+-]?\d+)?)
  | (?P<str>'(?:[^'\\]|\\.|'')*'|"(?:[^"\\]|\\.|"")*")
  | (?P<qident>`(?:[^`]|``)*`)
  | (?P<ident>[A-Za-z_\$][A-Za-z0-9_\$]*)
  | (?P<sysvar>@@(?:global\.|session\.)?[A-Za-z_][A-Za-z0-9_]*)
  | (?P<uservar>@[A-Za-z0-9_\.\$]+)
  | (?P<op><=>|<<|>>|!=|<>|<=|>=|:=|\|\||&&|[-+*/%=<>(),.;!~&|^?{}\[\]:@])
    """,
    re.X | re.S,
)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "0": "\0", "b": "\b", "Z": "\x1a", "\\": "\\", "'": "'", '"': '"', "%": "\\%", "_": "\\_"}


@dataclass
class Token:
    kind: str  # ident | qident | num | hex | str | op | sysvar | uservar | eof
    text: str
    pos: int

    @property
    def upper(self) -> str:
        return self.text.upper()


def _unquote_string(s: str) -> str:
    q = s[0]
    body = s[1:-1].replace(q + q, q)
    out = []
    i = 0
    while i < len(body):
        c = body[i]
        if c == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
        else:
            out.append(c)
            i += 1
    return "".join(out)


def tokenize(sql: str) -> list[Token]:
    toks: list[Token] = []
    pos = 0
    n = len(sql)
    while pos < n:
        m = TOKEN_RE.match(sql, pos)
        if not m:
            raise ParseError(f"unexpected character {sql[pos]!r} at offset {pos}")
        kind = m.lastgroup
        text = m.group()
        if kind != "ws":
            if kind == "str":
                text = _unquote_string(text)
            elif kind == "qident":
                text = text[1:-1].replace("``", "`")
            toks.append(Token(kind, text, pos))
        pos = m.end()
    toks.append(Token("eof", "", n))
    return toks
