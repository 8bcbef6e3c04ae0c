"""RIB front-end: lexer and parser.

JAX replacement for lucille's flex/bison front-end
(src/lsh/lexrib.l, src/lsh/parserib.y): a hand-written tokenizer and a
table-driven command parser that emits calls into the Ri state machine
(`lucille_tpu.ri.api`).  Supports the same surface: the ~45 RIB commands of
parserib.y:123-161, gzip'd input (main.c:167-179), ReadArchive include
stacks (lexrib.l:21-40), and unknown-command tolerance with a 30-strike
abort (parserib.y:41-42,869-871).
"""

from lucille_tpu.rib.lexer import Token, TokenKind, tokenize, tokenize_file
from lucille_tpu.rib.parser import ParseError, parse_rib, parse_rib_file

__all__ = [
    "Token",
    "TokenKind",
    "tokenize",
    "tokenize_file",
    "parse_rib",
    "parse_rib_file",
    "ParseError",
]
