"""Evaluation helpers (the port's copy of
``autosmoothquant_tpu/utils/eval_utils.py``; the reference's
``utils/eval_utils.py:9-23``)."""

from __future__ import annotations

import fnmatch
from typing import Dict, Iterable, List


def pattern_match(patterns: Iterable[str], source_list: Iterable[str]) -> List[str]:
    """The sorted names of ``source_list`` that any fnmatch pattern of
    ``patterns`` matches (task-name expansion)."""
    names = set()
    for pattern in patterns:
        for name in fnmatch.filter(source_list, pattern):
            names.add(name)
    return sorted(names)


def update_results(results: Dict, new_result: Dict) -> Dict:
    """Merge ``new_result`` into the nested dict ``results`` in place (dicts
    merge key by key, anything else is replaced); returns ``results``."""
    for key, value in new_result.items():
        if key in results and isinstance(results[key], dict) \
                and isinstance(value, dict):
            update_results(results[key], value)
        else:
            results[key] = value
    return results
