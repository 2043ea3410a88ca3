"""Layer ignore patterns for fp8 quantization (the port's copy of
``autosmoothquant_tpu/quant/ignore.py``).

A pattern is a literal module name or a regex prefixed with "re:"; the
reference CLI's default is "re:.*lm_head". The lm_head is never quantized by
construction; patterns exempt further projections from fp8."""

from __future__ import annotations

import re
from typing import Iterable, List, Sequence


def match_ignore_patterns(names: Iterable[str],
                          patterns: Sequence[str]) -> List[str]:
    """The subset of ``names`` matching any pattern: "re:<regex>" patterns
    by ``re.match``, the others exactly."""
    out = []
    regexes = []
    literals = set()
    for p in patterns:
        if p.startswith("re:"):
            regexes.append(re.compile(p[len("re:"):]))
        else:
            literals.add(p)
    for name in names:
        if name in literals or any(r.match(name) for r in regexes):
            out.append(name)
    return out


DEFAULT_IGNORE = ("re:.*lm_head",)
