"""SQL front end: lexer, AST and parser (copy of tidb_tpu/parser/)."""

from .parser import parse, parse_one, ParseError
from . import ast
