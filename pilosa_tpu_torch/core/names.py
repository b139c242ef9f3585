"""Name and label validation (reference: pilosa.go:52,104-121)."""

from __future__ import annotations

import re

# reference: pilosa.go:52 — ^[a-z][a-z0-9_-]*$ capped at 64 chars
_NAME_RE = re.compile(r"^[a-z][a-z0-9_-]{0,63}$")
# labels allow mixed case (reference: pilosa.go:53)
_LABEL_RE = re.compile(r"^[A-Za-z][A-Za-z0-9_-]{0,63}$")


class ValidationError(ValueError):
    pass


def validate_name(name: str) -> str:
    if not _NAME_RE.match(name or ""):
        raise ValidationError(f"invalid index or frame name: {name!r}")
    return name


def validate_label(label: str) -> str:
    if not _LABEL_RE.match(label or ""):
        raise ValidationError(f"invalid label: {label!r}")
    return label
