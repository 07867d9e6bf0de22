"""MetricVector comparison for BGP-injected route selection.

Port note: a copy of ``openr_tpu/decision/metric_vector.py``; nothing
left out.

Behavioral parity with the reference ``MetricVectorUtils``
(openr/common/Util.cpp, openr/common/Util.h:503): entities sorted by
priority descending, lexicographic comparison per entity, loner handling
by CompareType (WIN_IF_PRESENT / WIN_IF_NOT_PRESENT /
IGNORE_IF_NOT_PRESENT), tie-breaker entities produce TIE_WINNER/TIE_LOOSER
that only decide if nothing decisive appears, version mismatch is ERROR.
"""

from __future__ import annotations

import enum
from typing import Optional, Tuple

from openr_tpu_torch.types.lsdb import CompareType, MetricEntity, MetricVector

__all__ = [
    "CompareType",
    "MetricEntity",
    "MetricVector",
    "CompareResult",
    "compare_metric_vectors",
]


class CompareResult(enum.IntEnum):
    WINNER = 0
    TIE_WINNER = 1
    TIE = 2
    TIE_LOOSER = 3
    LOOSER = 4
    ERROR = 5


def _invert(r: CompareResult) -> CompareResult:
    return {
        CompareResult.WINNER: CompareResult.LOOSER,
        CompareResult.TIE_WINNER: CompareResult.TIE_LOOSER,
        CompareResult.TIE: CompareResult.TIE,
        CompareResult.TIE_LOOSER: CompareResult.TIE_WINNER,
        CompareResult.LOOSER: CompareResult.WINNER,
        CompareResult.ERROR: CompareResult.ERROR,
    }[r]


def _is_decisive(r: CompareResult) -> bool:
    return r in (CompareResult.WINNER, CompareResult.LOOSER, CompareResult.ERROR)


def _compare_metrics(
    l: Tuple[int, ...], r: Tuple[int, ...], tie_breaker: bool
) -> CompareResult:
    if len(l) != len(r):
        return CompareResult.ERROR
    for lv, rv in zip(l, r):
        if lv > rv:
            return (
                CompareResult.TIE_WINNER if tie_breaker else CompareResult.WINNER
            )
        if lv < rv:
            return (
                CompareResult.TIE_LOOSER if tie_breaker else CompareResult.LOOSER
            )
    return CompareResult.TIE


def _result_for_loner(entity: MetricEntity) -> CompareResult:
    if entity.op == CompareType.WIN_IF_PRESENT:
        return (
            CompareResult.TIE_WINNER
            if entity.is_best_path_tie_breaker
            else CompareResult.WINNER
        )
    if entity.op == CompareType.WIN_IF_NOT_PRESENT:
        return (
            CompareResult.TIE_LOOSER
            if entity.is_best_path_tie_breaker
            else CompareResult.LOOSER
        )
    return CompareResult.TIE  # IGNORE_IF_NOT_PRESENT


def _maybe_update(target: CompareResult, update: CompareResult) -> CompareResult:
    if _is_decisive(update) or target == CompareResult.TIE:
        return update
    return target


def compare_metric_vectors(
    l: Optional[MetricVector], r: Optional[MetricVector]
) -> CompareResult:
    """reference: MetricVectorUtils::compareMetricVectors."""
    if l is None or r is None:
        return CompareResult.ERROR
    if l.version != r.version:
        return CompareResult.ERROR
    result = CompareResult.TIE
    lm, rm = l.sorted_metrics(), r.sorted_metrics()
    li = ri = 0
    while not _is_decisive(result) and li < len(lm) and ri < len(rm):
        le, re = lm[li], rm[ri]
        if le.type == re.type:
            if le.is_best_path_tie_breaker != re.is_best_path_tie_breaker:
                result = _maybe_update(result, CompareResult.ERROR)
            else:
                result = _maybe_update(
                    result,
                    _compare_metrics(
                        le.metric, re.metric, le.is_best_path_tie_breaker
                    ),
                )
            li += 1
            ri += 1
        elif le.priority > re.priority:
            result = _maybe_update(result, _result_for_loner(le))
            li += 1
        elif le.priority < re.priority:
            result = _maybe_update(result, _invert(_result_for_loner(re)))
            ri += 1
        else:
            # same priority, different types: ambiguous
            result = _maybe_update(result, CompareResult.ERROR)
    while not _is_decisive(result) and li < len(lm):
        result = _maybe_update(result, _result_for_loner(lm[li]))
        li += 1
    while not _is_decisive(result) and ri < len(rm):
        result = _maybe_update(result, _invert(_result_for_loner(rm[ri])))
        ri += 1
    return result
