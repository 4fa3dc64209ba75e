"""EquivalenceProperties: equivalence classes, constants, and orderings.

Tracks what the optimizer may soundly assume about an operator's output:
which expressions are known *equal* (from `a = b` filters, join equi-keys
and projection aliases), which are known *constant* (from `a = 5`
filters), and which *orderings* hold. Sort elision / partial-sort
rewrites consult these instead of raw string prefix matching, so
`ORDER BY b` over `WHERE a = b` with an `a`-sorted input is recognized
as satisfied.

Reference: `datafusion/physical-expr/src/equivalence/properties.rs`
(EquivalenceProperties: eq_group + oeq_class + constants,
`ordering_satisfy` properties.rs:517), `equivalence/class.rs`
(EquivalenceGroup/EquivalenceClass), `equivalence/projection.rs`
(ProjectionMapping). Expressions are tracked by display string
("name@index" for columns) — the same pragmatic key the plan layer uses
for orderings.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Set, Tuple

SortKey = Tuple[str, bool, bool]  # (expr display, asc, nulls_first)


class EquivalenceProperties:
    """Equal-expression classes + constant expressions + valid orderings."""

    def __init__(self,
                 orderings: Sequence[Sequence[SortKey]] = (),
                 classes: Sequence[Set[str]] = (),
                 constants: Sequence[str] = ()):
        self.orderings: List[List[SortKey]] = [list(o) for o in orderings if o]
        self.classes: List[Set[str]] = [set(c) for c in classes if len(c) > 1]
        self.constants: Set[str] = set(constants)

    # ---- construction ------------------------------------------------------
    def copy(self) -> "EquivalenceProperties":
        return EquivalenceProperties(self.orderings, self.classes,
                                     self.constants)

    def add_equal(self, a: str, b: str) -> None:
        """Record a == b (reference: EquivalenceGroup::add_equal_conditions,
        class.rs — merges the classes containing either side)."""
        if a == b:
            return
        ca = self._class_of(a)
        cb = self._class_of(b)
        if ca is not None and cb is not None:
            if ca is not cb:
                ca |= cb
                self.classes.remove(cb)
        elif ca is not None:
            ca.add(b)
        elif cb is not None:
            cb.add(a)
        else:
            self.classes.append({a, b})
        # constants propagate across a class: if either side is constant,
        # the merged class is constant
        merged = self._class_of(a)
        if merged and (merged & self.constants):
            self.constants |= merged

    def add_constant(self, key: str) -> None:
        self.constants.add(key)
        c = self._class_of(key)
        if c:
            self.constants |= c

    def add_ordering(self, ordering: Sequence[SortKey]) -> None:
        o = list(ordering)
        if o and o not in self.orderings:
            self.orderings.append(o)

    # ---- queries -----------------------------------------------------------
    def _class_of(self, key: str) -> Optional[Set[str]]:
        for c in self.classes:
            if key in c:
                return c
        return None

    def is_constant(self, key: str) -> bool:
        return key in self.constants

    def normalize_key(self, key: str) -> str:
        """Canonical member of `key`'s class (stable: lexicographic min)."""
        c = self._class_of(key)
        return min(c) if c else key

    def _normalized_orderings(self) -> List[List[SortKey]]:
        out = []
        for o in self.orderings:
            norm = [(self.normalize_key(k), asc, nf) for k, asc, nf in o
                    if not self.is_constant(k)]
            out.append(norm)
        if not out:
            out.append([])  # all-constant input still satisfies const-only
        return out

    def satisfied_prefix(self, required: Sequence[SortKey]) -> int:
        """Longest leading run of `required` this output already delivers
        (reference: ordering_satisfy_requirement, properties.rs:517).
        Constant keys are trivially ordered at any position; other keys
        compare class-normalized against each known ordering in turn."""
        best = 0
        for have in self._normalized_orderings():
            i = 0   # position in required
            j = 0   # position in have
            while i < len(required):
                key, asc, nf = required[i]
                if self.is_constant(key):
                    i += 1
                    continue
                norm = (self.normalize_key(key), asc, nf)
                if j < len(have) and have[j] == norm:
                    i += 1
                    j += 1
                    continue
                break
            best = max(best, i)
            if best == len(required):
                break
        return best

    def ordering_satisfied(self, required: Sequence[SortKey]) -> bool:
        return self.satisfied_prefix(required) == len(required)

    # ---- transformations ----------------------------------------------------
    def with_reorder(self, ordering: Sequence[SortKey]) -> "EquivalenceProperties":
        """Properties after a full sort by `ordering`: classes and
        constants survive; the sort keys become the (single) known
        ordering (reference: properties.rs with_reorder)."""
        return EquivalenceProperties([list(ordering)], self.classes,
                                     self.constants)

    def project(self, alias_pairs: Sequence[Tuple[str, str]]
                ) -> "EquivalenceProperties":
        """Map through a projection. `alias_pairs` is
        [(input expr display, output column display), ...] — one pair per
        output column whose value *is* that input expression (reference:
        ProjectionMapping, equivalence/projection.rs)."""
        fwd: Dict[str, List[str]] = {}
        for src, dst in alias_pairs:
            fwd.setdefault(src, []).append(dst)

        def outs(key: str) -> List[str]:
            got = list(fwd.get(key, []))
            c = self._class_of(key)
            if c:
                for member in sorted(c):
                    for d in fwd.get(member, []):
                        if d not in got:
                            got.append(d)
            return got

        new = EquivalenceProperties()
        # classes: surviving members of each class, plus duplicate aliases
        # of the same input expression form a class of their own
        for c in self.classes:
            mapped: Set[str] = set()
            for member in c:
                mapped.update(fwd.get(member, []))
            if len(mapped) > 1:
                new.classes.append(mapped)
        for src, dsts in fwd.items():
            if len(dsts) > 1:
                for d in dsts[1:]:
                    new.add_equal(dsts[0], d)
        # constants survive if any alias exists
        for k in self.constants:
            for d in outs(k):
                new.constants.add(d)
        # orderings: rewrite keys through the mapping; stop at the first
        # key with no surviving alias (prefix rule); constants are skipped
        for o in self.orderings:
            result: List[SortKey] = []
            for key, asc, nf in o:
                if self.is_constant(key):
                    continue
                got = outs(key)
                if not got:
                    break
                result.append((got[0], asc, nf))
            if result:
                new.add_ordering(result)
        return new

    @staticmethod
    def join(left: "EquivalenceProperties",
             right: "EquivalenceProperties",
             n_left_fields: int,
             on_pairs: Sequence[Tuple[str, str]] = (),
             orderings: Sequence[Sequence[SortKey]] = ()
             ) -> "EquivalenceProperties":
        """Combine the two sides of an INNER join: right-side keys shift
        into the output column space (left fields first), equi-join keys
        become equal (reference: join_equivalence_properties,
        properties.rs:2137). `on_pairs` are (left display, shifted right
        display)."""
        def shift(key: str) -> str:
            name, _, idx = key.rpartition("@")
            if name and idx.isdigit():
                return f"{name}@{int(idx) + n_left_fields}"
            return key

        new = EquivalenceProperties(orderings)
        for c in left.classes:
            new.classes.append(set(c))
        for c in right.classes:
            new.classes.append({shift(k) for k in c})
        new.constants = set(left.constants) | {shift(k)
                                               for k in right.constants}
        for a, b in on_pairs:
            new.add_equal(a, b)
        return new


def properties_from_filter(child_props: EquivalenceProperties,
                           predicate) -> EquivalenceProperties:
    """Fold `a = b` / `a = literal` conjuncts of a filter predicate into
    the child's properties (reference: FilterExec::equivalence_properties,
    filter.rs:180 — collect_columns over equal conditions)."""
    from .expressions import BinaryPhysExpr, ColumnExpr, LiteralExpr

    props = child_props.copy()

    def walk(e):
        if not isinstance(e, BinaryPhysExpr):
            return
        opv = getattr(e.op, "value", str(e.op))
        if opv == "AND":
            walk(e.left)
            walk(e.right)
        elif opv == "=":
            l, r = e.left, e.right
            if isinstance(l, ColumnExpr) and isinstance(r, ColumnExpr):
                props.add_equal(str(l), str(r))
            elif isinstance(l, ColumnExpr) and isinstance(r, LiteralExpr):
                props.add_constant(str(l))
            elif isinstance(r, ColumnExpr) and isinstance(l, LiteralExpr):
                props.add_constant(str(r))

    walk(predicate)
    return props
