"""The SQL front end: lexer, parser, planner (AST to MIR) and lowering (MIR to LIR).

Counterpart of materialize_tpu/sql/.
"""

from . import ast
from .parser import ParseError, lex, parse_statement, parse_statements
from .plan import PlanError, Planner

__all__ = [
    "ast",
    "lex",
    "ParseError",
    "parse_statement",
    "parse_statements",
    "PlanError",
    "Planner",
]
