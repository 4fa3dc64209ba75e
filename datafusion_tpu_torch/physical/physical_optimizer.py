"""Physical optimizer rules of the port.

The reference's `default_physical_rules`
(`datafusion_tpu/physical/physical_optimizer.py:1352-1357`) include device
rules that reach JAX (mesh sizing, device join rows, the HAVING fusion's
lowering check) or build `DeviceGroupAggregateExec` itself, so the port
runs its own list, in the reference's order: `UseTorchAggregate` in place
of `UseDeviceAggregate`, the reference's host-only rules, then
`FuseTopKIntoTorchAggregate` and `FuseFilterIntoTorchAggregate`.
"""
from __future__ import annotations

import copy
from typing import Optional

import torch

from datafusion_tpu.physical.expressions import ColumnExpr
from datafusion_tpu.physical.physical_optimizer import (
    RemoveRedundantSort, RepartitionFileScans, UseDeviceAggregate,
    UseSymmetricHashJoin, _DEVICE_AGG_NAMES, _pipeline_check, _unwrap_chain)
from datafusion_tpu.physical.plan.aggregate import AggregateExec, AggregateMode
from datafusion_tpu.physical.plan.base import ExecutionPlan
from datafusion_tpu.physical.plan.projection import (CoalescePartitionsExec,
                                                     FilterExec,
                                                     ProjectionExec)
from datafusion_tpu.physical.plan.sort import SortExec

from ..common.column import DeviceColumnCache
from ..device.groupby import MAX_TOPK
from ..device.lower import LoweringError, check_having
from .plan.device_aggregate import TorchGroupAggregateExec


class UseTorchAggregate(UseDeviceAggregate):
    """Fuse AggregateExec(Single) with its Filter / Projection input chain
    into a TorchGroupAggregateExec, under the admission checks of
    `UseDeviceAggregate` (`:46-57`). No mesh branch, no join fusion."""
    name = "use_torch_aggregate"

    def __init__(self, config, device: torch.device,
                 cache: Optional[DeviceColumnCache] = None):
        super().__init__(config)
        self.device = device
        self.cache = cache

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        if not self.enabled():
            return plan

        def f(node):
            if not isinstance(node, AggregateExec) or \
                    node.mode != AggregateMode.SINGLE:
                return node
            for a in node.aggr_exprs:
                if a.name not in _DEVICE_AGG_NAMES or a.filter is not None:
                    return node
                if a.distinct and not (a.name == "count" and a.args):
                    return node
                if a.name in ("min", "max") and a.out_type.is_string:
                    return node
            unwrapped = _unwrap_chain(node)
            if unwrapped is None:
                return node
            source, predicate, groups, aggs = unwrapped
            return TorchGroupAggregateExec(
                source, predicate, groups, aggs, node.schema(),
                fallback=node, device=self.device, cache=self.cache)
        return plan.transform_up(f)


class FuseTopKIntoTorchAggregate:
    """ORDER BY <count aggregate> LIMIT k (k <= 2^16) over a
    TorchGroupAggregateExec: push (aggregate, direction, k) into the exec,
    which selects the k groups on the card (`group_topk`) so only k rows
    reach the host. The port of `FuseTopKIntoDeviceAggregate` (`:1225`),
    with its restrictions: one sort key, a count (never NULL), reached
    through projections of plain columns. The SortExec stays and orders
    the k rows exactly; among groups tied at the k-th count any choice is
    valid SQL."""

    def __init__(self, config=None):
        self.config = config

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        def f(node):
            if not isinstance(node, SortExec) or node.fetch is None or \
                    node.fetch > MAX_TOPK or len(node.sort_exprs) != 1:
                return node
            se = node.sort_exprs[0]
            if not isinstance(se.expr, ColumnExpr):
                return node
            idx = se.expr.index
            cur = node.input
            while isinstance(cur, (ProjectionExec, CoalescePartitionsExec)):
                if isinstance(cur, ProjectionExec):
                    e = cur.exprs[idx]
                    if not isinstance(e, ColumnExpr):
                        return node
                    idx = e.index
                cur = cur.children()[0]
            if type(cur) is not TorchGroupAggregateExec or \
                    cur.topk is not None:
                return node
            n_keys = len(cur.group_exprs)
            if idx < n_keys or cur.aggs[idx - n_keys].name != "count":
                return node
            fused = TorchGroupAggregateExec(
                cur.source, cur.predicate, cur.group_exprs, cur.aggs,
                cur.schema(), cur.fallback, cur.device, cur.cache,
                cur.max_groups, topk=(idx - n_keys, se.asc, int(node.fetch)))

            def rebuild(n2):
                # descend the original objects so identity survives
                if n2 is cur:
                    return fused
                return n2.with_children([rebuild(c) for c in n2.children()])
            return node.with_children([rebuild(node.input)])
        return plan.transform_up(f)


class FuseFilterIntoTorchAggregate:
    """A FilterExec directly above a grouped TorchGroupAggregateExec (a
    HAVING) moves into the exec: `compact_groups` evaluates it over the
    finalised group table on the card, so only surviving groups reach the
    host. The port of `FuseFilterIntoDeviceAggregate` (`:1283`); its
    fusability check is the port's own lowering (`check_having`), and the
    fallback keeps the FilterExec above the host plan."""

    def __init__(self, config=None):
        self.config = config

    def rewrite(self, plan: ExecutionPlan) -> ExecutionPlan:
        def f(node):
            if not isinstance(node, FilterExec):
                return node
            child = node.children()[0]
            if not isinstance(child, TorchGroupAggregateExec) or \
                    child.topk is not None or \
                    child.post_filter is not None or \
                    not child.group_exprs:
                # scalar aggregates emit exactly one row (made up even for
                # empty input): their HAVING runs on the host above
                return node
            try:
                check_having(node.predicate,
                             [e.out_type for e, _ in child.group_exprs],
                             child.aggs)
            except LoweringError:
                return node
            fused = copy.copy(child)
            fused.post_filter = node.predicate
            fused.fallback = FilterExec(node.predicate, child.fallback)
            return fused
        return plan.transform_up(f)


def optimize_physical(plan: ExecutionPlan, config, device: torch.device,
                      cache: Optional[DeviceColumnCache] = None
                      ) -> ExecutionPlan:
    for rule in (UseTorchAggregate(config, device, cache),
                 RemoveRedundantSort(config), UseSymmetricHashJoin(config),
                 RepartitionFileScans(config),
                 FuseTopKIntoTorchAggregate(config),
                 FuseFilterIntoTorchAggregate(config)):
        plan = rule.rewrite(plan)
    return _pipeline_check(plan)
