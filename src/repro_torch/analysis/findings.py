"""Finding model and inline waivers of the port's lock lint (the
reference's ``repro/analysis/findings.py`` without its baseline: the port
has no grandfathered finding, so every one is fixed or waived where it
stands). Stdlib only.

Every pass reports :class:`Finding` objects that print as
``file:line RULE message``, the grep/CI-friendly shape.

**Inline waivers** (``# lock-ok: RULE reason``, on the offending line or
the line directly above) mark *intentional designs* the rule cannot
distinguish from bugs. They live next to the code, carry their
justification, and are reviewed whenever the code changes. Waived
findings are still reported (tagged) but never fail ``--check``.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Optional, Sequence


@dataclasses.dataclass
class Finding:
    rule: str
    file: str                  # repo-relative path
    line: int
    message: str
    symbol: str = ""           # "Class.method" when known
    waived: bool = False
    waive_reason: str = ""
    #: informational (DEAD002): reported, never fails ``--check``
    advice: bool = False

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        tag = " (waived)" if self.waived else \
              " (info)" if self.advice else ""
        return f"{self.file}:{self.line} {self.rule} {self.message}" \
               f"{sym}{tag}"


_WAIVER_RE = re.compile(r"#\s*lock-ok:\s*([A-Z]+\d+)\b\s*(.*)")


def waiver_on(lines: Sequence[str], lineno: int,
              rule: str) -> Optional[str]:
    """Return the waiver reason if ``lines`` carries an inline
    ``# lock-ok: <rule>`` marker on ``lineno`` (1-based) or the line
    directly above it."""
    for ln in (lineno, lineno - 1):
        if 1 <= ln <= len(lines):
            m = _WAIVER_RE.search(lines[ln - 1])
            if m and m.group(1) == rule:
                return m.group(2).strip() or "waived"
    return None
