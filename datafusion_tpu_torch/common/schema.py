"""Field / Schema — the engine's schema layer.

Reference parity: `DFSchema` (`datafusion/common/src/dfschema.rs:108`) —
fields carry an optional relation qualifier so SQL name resolution can
disambiguate `t1.a` vs `t2.a`; unqualified lookup errors on ambiguity.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Tuple

from .datatypes import DataType
from .errors import SchemaError


@dataclasses.dataclass(frozen=True)
class Field:
    name: str
    dtype: DataType
    nullable: bool = True
    # relation qualifier, e.g. table name or alias ("lineitem")
    qualifier: Optional[str] = None
    # declared PRIMARY KEY / UNIQUE member: grouping by all such fields of a
    # relation functionally determines its other fields (reference:
    # common/src/functional_dependencies.rs)
    primary_key: bool = False

    def with_qualifier(self, q: Optional[str]) -> "Field":
        return dataclasses.replace(self, qualifier=q)

    def qualified_name(self) -> str:
        return f"{self.qualifier}.{self.name}" if self.qualifier else self.name

    def __str__(self) -> str:
        return f"{self.qualified_name()}: {self.dtype}{'' if self.nullable else ' NOT NULL'}"


class Schema:
    """An ordered list of fields with qualified/unqualified resolution."""

    __slots__ = ("fields", "_index")

    def __init__(self, fields: Iterable[Field]):
        self.fields: Tuple[Field, ...] = tuple(fields)
        idx = {}
        for i, f in enumerate(self.fields):
            # field names match case-SENSITIVELY (the reference lowercases
            # unquoted idents at parse time and exact-matches after:
            # common/src/dfschema.rs index_of_column_by_name); qualifiers
            # (table aliases) are normalized to lowercase by the planner
            idx.setdefault(f.name, []).append(i)
            if f.qualifier:
                idx.setdefault(f"{f.qualifier.lower()}.{f.name}", []).append(i)
        self._index = idx

    # ---- construction ----------------------------------------------------
    @staticmethod
    def empty() -> "Schema":
        return Schema(())

    def with_qualifier(self, q: Optional[str]) -> "Schema":
        return Schema(f.with_qualifier(q) for f in self.fields)

    def merge(self, other: "Schema") -> "Schema":
        return Schema(self.fields + other.fields)

    def project(self, indices: Sequence[int]) -> "Schema":
        return Schema(self.fields[i] for i in indices)

    # ---- lookup ------------------------------------------------------------
    def __len__(self) -> int:
        return len(self.fields)

    def __iter__(self):
        return iter(self.fields)

    def field(self, i: int) -> Field:
        return self.fields[i]

    def names(self) -> List[str]:
        return [f.name for f in self.fields]

    def check_ambiguous_names(self) -> "Schema":
        """DFSchema validation: an unqualified output field whose name equals
        a qualified field's name is ambiguous (reference:
        common/src/dfschema.rs check_ambiguous_name). Used by projection-
        producing plan nodes; returns self for chaining."""
        qual = {f.name: f for f in self.fields if f.qualifier}
        for f in self.fields:
            q = qual.get(f.name)
            if f.qualifier is None and q is not None:
                raise SchemaError(
                    f"Schema contains qualified field name "
                    f"{q.qualifier}.{q.name} and unqualified field name "
                    f"{f.name} which would be ambiguous")
        return self

    def index_of(self, name: str, qualifier: Optional[str] = None) -> int:
        """Resolve a (possibly qualified) column name to a field index."""
        key = f"{qualifier.lower()}.{name}" if qualifier else name
        hits = self._index.get(key, [])
        if not hits and qualifier is None:
            raise SchemaError(
                f'No field named "{name}". Valid fields: '
                + ", ".join(f.qualified_name() for f in self.fields))
        if not hits:
            # maybe the name itself is unambiguous without qualifier match
            raise SchemaError(
                f'No field named "{qualifier}.{name}". Valid fields: '
                + ", ".join(f.qualified_name() for f in self.fields))
        if len(hits) > 1:
            if qualifier is None:
                # ambiguity allowed if all hits refer to same qualified field?
                quals = {self.fields[i].qualifier for i in hits}
                if len(quals) > 1:
                    raise SchemaError(
                        f'Ambiguous reference to unqualified field "{name}" '
                        f"(candidates: {', '.join(self.fields[i].qualified_name() for i in hits)})")
            else:
                raise SchemaError(f'Ambiguous reference to "{qualifier}.{name}"')
        return hits[0]

    def maybe_index_of(self, name: str, qualifier: Optional[str] = None) -> Optional[int]:
        try:
            return self.index_of(name, qualifier)
        except SchemaError:
            return None

    def field_by_name(self, name: str, qualifier: Optional[str] = None) -> Field:
        return self.fields[self.index_of(name, qualifier)]

    def has(self, name: str, qualifier: Optional[str] = None) -> bool:
        key = f"{qualifier.lower()}.{name}" if qualifier else name
        return key in self._index

    # ---- misc ------------------------------------------------------------
    def __eq__(self, other) -> bool:
        return isinstance(other, Schema) and \
            [(f.name, f.dtype) for f in self.fields] == [(f.name, f.dtype) for f in other.fields]

    def __hash__(self):
        return hash(tuple((f.name, f.dtype) for f in self.fields))

    def __str__(self) -> str:
        return "[" + ", ".join(str(f) for f in self.fields) + "]"

    __repr__ = __str__
