"""Logical plan + rule-based optimizer for Datasets: the port's copy of
``ray_tpu/data/plan.py``.

Reference parity: data/_internal/logical/interfaces/logical_operator.py:10
(LogicalOperator tree), logical/optimizers.py (rule-based LogicalPlan
optimization) and the physical planner's map-fusion
(data/_internal/planner/plan_udf_map_op.py — consecutive map-like
operators fuse into ONE task per block). Redesign: operators are small
dataclasses exposing a per-block callable; the optimizer is a list of
`Rule`s applied to fixpoint; "physical" compilation composes the final
operator chain into one fused block function that the streaming
executor ships per block.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

Block = list


@dataclasses.dataclass(frozen=True)
class LogicalOperator:
    """Base logical operator. `one_to_one` marks row-count-preserving
    operators (safe to swap with Limit)."""

    name: str = dataclasses.field(init=False, default="op")
    one_to_one = False

    def block_fn(self) -> Callable[[Block], Block]:
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class Read(LogicalOperator):
    """Materialize a block from its read task (the block holds the
    pending ReadTask; see datasource.py)."""

    fn: Callable[[Block], Block] = None
    name = "Read"

    def block_fn(self):
        return self.fn


@dataclasses.dataclass(frozen=True)
class MapRows(LogicalOperator):
    fn: Callable[[Any], Any] = None
    name = "MapRows"
    one_to_one = True

    def block_fn(self):
        from ray_tpu_torch.data.block import to_rows

        f = self.fn
        return lambda b: [f(r) for r in to_rows(b)]


@dataclasses.dataclass(frozen=True)
class FilterRows(LogicalOperator):
    fn: Callable[[Any], bool] = None
    name = "Filter"

    def block_fn(self):
        from ray_tpu_torch.data.block import to_rows

        f = self.fn
        return lambda b: [r for r in to_rows(b) if f(r)]


@dataclasses.dataclass(frozen=True)
class FlatMapRows(LogicalOperator):
    fn: Callable[[Any], list] = None
    name = "FlatMap"

    def block_fn(self):
        from ray_tpu_torch.data.block import to_rows

        f = self.fn
        return lambda b: [o for r in to_rows(b) for o in f(r)]


@dataclasses.dataclass(frozen=True)
class MapBatches(LogicalOperator):
    """Whole-block UDF (already adapted to block form upstream)."""

    fn: Callable[[Block], Block] = None
    name = "MapBatches"

    def block_fn(self):
        return self.fn


@dataclasses.dataclass(frozen=True)
class Limit(LogicalOperator):
    """Per-block row cap; the consuming iterator enforces the GLOBAL
    cap (reference: logical Limit + per-block slicing)."""

    n: int = 0
    name = "Limit"

    def block_fn(self):
        from ray_tpu_torch.data.block import slice_block

        n = self.n
        return lambda b: slice_block(b, 0, n)


@dataclasses.dataclass(frozen=True)
class Fused(LogicalOperator):
    """Result of map-fusion: one composed block function, its inputs
    kept for describe()."""

    parts: tuple = ()
    name = "Fused"

    def block_fn(self):
        fns = [p.block_fn() for p in self.parts]

        def fused(b):
            for f in fns:
                b = f(b)
            return b

        return fused


# ------------------------------------------------------------ optimizer


class Rule:
    """One rewrite over the operator chain (reference:
    logical/interfaces/optimizer.py Rule)."""

    def apply(self, ops: list[LogicalOperator]) -> list[LogicalOperator]:
        raise NotImplementedError


class LimitPushdown(Rule):
    """Move Limit before row-count-preserving operators so the capped
    rows skip upstream per-row work (reference:
    logical/rules/limit_pushdown.py). `limit∘map == map∘limit` only
    when the map is 1:1 — Filter/FlatMap/MapBatches block the push."""

    def apply(self, ops):
        ops = list(ops)
        changed = True
        while changed:
            changed = False
            for i in range(1, len(ops)):
                if isinstance(ops[i], Limit) and ops[i - 1].one_to_one:
                    ops[i - 1], ops[i] = ops[i], ops[i - 1]
                    changed = True
        return ops


class RedundantLimitElimination(Rule):
    """Adjacent limits collapse to the smaller one."""

    def apply(self, ops):
        out: list[LogicalOperator] = []
        for op in ops:
            if isinstance(op, Limit) and out and isinstance(out[-1], Limit):
                out[-1] = Limit(min(out[-1].n, op.n))
            else:
                out.append(op)
        return out


class MapFusion(Rule):
    """Fuse every run of consecutive block-local operators into one
    Fused operator — one task per block regardless of chain length
    (reference: the physical planner's map fusion)."""

    def apply(self, ops):
        if len(ops) <= 1:
            return list(ops)
        return [Fused(tuple(ops))]


DEFAULT_RULES: list[Rule] = [LimitPushdown(), RedundantLimitElimination(),
                             MapFusion()]


@dataclasses.dataclass
class LogicalPlan:
    ops: list[LogicalOperator]

    def describe(self) -> str:
        def nm(op):
            if isinstance(op, Fused):
                return "Fused[" + "->".join(nm(p) for p in op.parts) + "]"
            return op.name

        return " -> ".join(nm(op) for op in self.ops) or "Scan"

    def optimized(self, rules: list[Rule] | None = None) -> "LogicalPlan":
        ops = list(self.ops)
        for rule in (rules if rules is not None else DEFAULT_RULES):
            ops = rule.apply(ops)
        return LogicalPlan(ops)

    def compile(self) -> Callable[[Block], Block]:
        """Physical form: one fused per-block callable. (With the
        default rules MapFusion already collapsed chains; Fused covers
        any custom rule set that leaves several operators.)"""
        ops = self.optimized().ops
        if not ops:
            return lambda b: b
        if len(ops) == 1:
            return ops[0].block_fn()
        return Fused(tuple(ops)).block_fn()

    def global_limit(self) -> int | None:
        """The plan's overall row cap, if its SUFFIX is only limits and
        1:1 ops (the iterator stops the stream there)."""
        n = None
        for op in reversed(self.ops):
            if isinstance(op, Limit):
                n = op.n if n is None else min(n, op.n)
            elif not op.one_to_one:
                break
        return n
