"""PQL — the Pilosa Query Language (a copy of pilosa_tpu.pql.parser)."""

from pilosa_tpu_torch.pql.parser import (
    Call,
    Cond,
    ParseError,
    Query,
    TIME_FORMAT,
    parse_string,
)

__all__ = ["Call", "Cond", "ParseError", "Query", "TIME_FORMAT", "parse_string"]
