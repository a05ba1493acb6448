"""Source-anchored compiler diagnostics — the static-analysis spine.

Every stage of the pipeline (parse -> translate -> rewrite -> analyze)
raises a ``QueryError`` subclass carrying enough anchoring to point at
the problem: a character offset into the query text for parse- and
translate-time errors, an operator path (root -> offending operator)
for plan-level errors from ``core.analysis``.  ``str(err)`` renders a
caret snippet once the query text is attached (``with_text``), so a
failure inside ``QueryService.prepare()`` reads like a compiler
diagnostic rather than a JAX trace dump.

The subclasses multiple-inherit from the builtin exception each stage
used to raise (``SyntaxError``, ``ValueError``, ``NotImplementedError``)
so existing ``except``/``pytest.raises`` sites keep working.
"""
from __future__ import annotations

from typing import Iterable, Optional


def _line_col(text: str, pos: int) -> tuple[int, int, int]:
    """(1-based line, 1-based column, offset of beginning-of-line)."""
    pos = max(0, min(pos, len(text)))
    line = text.count("\n", 0, pos) + 1
    bol = text.rfind("\n", 0, pos) + 1
    return line, pos - bol + 1, bol


class QueryError(Exception):
    """Base diagnostic.  ``pos`` is a character offset into ``text``
    (``-1`` when unknown); ``path`` is the operator chain from the plan
    root down to the operator the message is about."""

    stage = "query"

    def __init__(self, message: str, *, pos: int = -1,
                 text: Optional[str] = None,
                 path: Iterable[str] = ()) -> None:
        super().__init__(message)
        self.message = message
        self.pos = pos
        self.text = text
        self.path = tuple(path)

    def with_text(self, text: Optional[str]) -> "QueryError":
        """Attach the query text (once known) for caret rendering."""
        if self.text is None and text is not None:
            self.text = text
        return self

    def __str__(self) -> str:
        parts = [f"{self.stage} error: {self.message}"]
        if self.path:
            parts.append("  at " + " > ".join(self.path))
        if self.text is not None and self.pos >= 0:
            line, col, bol = _line_col(self.text, self.pos)
            eol = self.text.find("\n", bol)
            eol = len(self.text) if eol < 0 else eol
            parts.append(f"  line {line}, column {col}:")
            parts.append("    " + self.text[bol:eol])
            parts.append("    " + " " * (col - 1) + "^")
        return "\n".join(parts)


class ParseError(QueryError, SyntaxError):
    stage = "parse"


class TranslateError(QueryError, ValueError):
    stage = "translate"


class UnsupportedError(TranslateError, NotImplementedError):
    """Well-formed XQuery outside the supported subset."""
    stage = "translate"


class InvalidArgumentError(QueryError, ValueError):
    """A user-facing API argument is out of its documented domain
    (service constructor knobs, ``stack_params`` widths, warmup
    templates).  Replaces bare ``assert`` at validation sites — an
    assert disappears under ``python -O``, silently admitting the
    invalid value instead of diagnosing it."""
    stage = "config"


class PlanTypeError(QueryError, TypeError):
    """Schema/type inference rejection (analysis/schema.py)."""
    stage = "typecheck"


class CapFlowError(QueryError):
    """Capacity-flow analysis rejection (analysis/capflow.py)."""
    stage = "capflow"


class RewriteSoundnessError(QueryError):
    """A rewrite rule changed plan semantics (analysis/check.py)."""
    stage = "rewrite-soundness"


class TraceFormatError(QueryError, ValueError):
    """A flight-recorder trace failed schema validation
    (obs/recorder.py): unknown format/version, malformed JSON line, or
    a missing/ill-typed event field.  ``text`` is the offending trace
    line, so ``str(err)`` carets into the record like every other
    stage's diagnostic."""
    stage = "trace-format"
