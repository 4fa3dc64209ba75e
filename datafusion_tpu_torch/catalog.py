"""Pluggable catalog hierarchy: CatalogProvider -> SchemaProvider -> TableProvider.

Reference parity: `core/src/catalog/mod.rs:52` (CatalogProvider trait),
`core/src/catalog/schema.rs:34` (SchemaProvider), the Memory* impls
(`core/src/catalog/mod.rs:159`, `schema.rs:95`), and
`SessionContext::register_catalog` (`core/src/execution/context/mod.rs`).

The session's own catalogs are `FlatCatalog`s: a flat
`{qualified_name: TableProvider}` dict (the round-1 layout, kept so
single-catalog sessions stay one dict lookup) that *presents* the
CatalogProvider protocol and can host third-party SchemaProviders.
User-registered catalogs are consulted purely through the protocol, so
any object with `schema_names()/schema(name)` works — the extension
point the reference's trait objects provide.
"""
from __future__ import annotations

from typing import Dict, List, Optional


class SchemaProvider:
    """A named collection of tables (reference: schema.rs:34)."""

    def table_names(self) -> List[str]:
        raise NotImplementedError

    def table(self, name: str):
        """Return the TableProvider for `name`, or None."""
        raise NotImplementedError

    def table_exist(self, name: str) -> bool:
        return name in self.table_names()

    def register_table(self, name: str, table) -> None:
        raise NotImplementedError(
            "schema provider is read-only (reference: schema.rs:61)")

    def deregister_table(self, name: str) -> None:
        raise NotImplementedError(
            "schema provider is read-only (reference: schema.rs:70)")


class MemorySchemaProvider(SchemaProvider):
    """In-memory SchemaProvider (reference: schema.rs:95)."""

    def __init__(self):
        self._tables: Dict[str, object] = {}

    def table_names(self) -> List[str]:
        return sorted(self._tables)

    def table(self, name: str):
        return self._tables.get(name.lower())

    def register_table(self, name: str, table) -> None:
        self._tables[name.lower()] = table

    def deregister_table(self, name: str) -> None:
        self._tables.pop(name.lower(), None)


class CatalogProvider:
    """A named collection of schemas (reference: mod.rs:52)."""

    def schema_names(self) -> List[str]:
        raise NotImplementedError

    def schema(self, name: str) -> Optional[SchemaProvider]:
        raise NotImplementedError

    def register_schema(self, name: str, provider: SchemaProvider) -> None:
        raise NotImplementedError(
            "catalog provider is read-only (reference: mod.rs:81)")

    def deregister_schema(self, name: str) -> None:
        raise NotImplementedError


class MemoryCatalogProvider(CatalogProvider):
    """In-memory CatalogProvider (reference: mod.rs:159)."""

    def __init__(self):
        self._schemas: Dict[str, SchemaProvider] = {}

    def schema_names(self) -> List[str]:
        return sorted(self._schemas)

    def schema(self, name: str) -> Optional[SchemaProvider]:
        return self._schemas.get(name.lower())

    def register_schema(self, name: str, provider: SchemaProvider) -> None:
        self._schemas[name.lower()] = provider

    def deregister_schema(self, name: str) -> None:
        self._schemas.pop(name.lower(), None)


class _FlatSchemaView(SchemaProvider):
    """SchemaProvider view over one schema of a FlatCatalog. Bare keys in
    the flat dict belong to the `public` schema (round-1 convention)."""

    def __init__(self, cat: "FlatCatalog", name: str):
        self._cat = cat
        self._name = name

    def table_names(self) -> List[str]:
        pre = self._name + "."
        names = [k[len(pre):] for k in self._cat.flat if k.startswith(pre)
                 and "." not in k[len(pre):]]
        if self._name == "public":
            names += [k for k in self._cat.flat if "." not in k]
        return sorted(set(names))

    def table(self, name: str):
        t = self._cat.flat.get(f"{self._name}.{name.lower()}")
        if t is None and self._name == "public":
            t = self._cat.flat.get(name.lower())
        return t

    def register_table(self, name: str, table) -> None:
        key = name.lower() if self._name == "public" \
            else f"{self._name}.{name.lower()}"
        self._cat.flat[key] = table

    def deregister_table(self, name: str) -> None:
        self._cat.flat.pop(f"{self._name}.{name.lower()}", None)
        if self._name == "public":
            self._cat.flat.pop(name.lower(), None)


class FlatCatalog(CatalogProvider):
    """The session's own catalog type: flat `{schema.table | table:
    provider}` storage presenting the CatalogProvider protocol, plus a
    slot for externally registered SchemaProviders."""

    def __init__(self):
        self.flat: Dict[str, object] = {}
        self.schema_set = {"public"}          # CREATE SCHEMA declarations
        self.external: Dict[str, SchemaProvider] = {}

    def schema_names(self) -> List[str]:
        names = set(self.schema_set) | set(self.external)
        names.update(k.rsplit(".", 1)[0] for k in self.flat if "." in k)
        return sorted(names)

    def schema(self, name: str) -> Optional[SchemaProvider]:
        name = name.lower()
        if name in self.external:
            return self.external[name]
        if name in self.schema_names():
            return _FlatSchemaView(self, name)
        return None

    def register_schema(self, name: str, provider: SchemaProvider) -> None:
        self.external[name.lower()] = provider

    def deregister_schema(self, name: str) -> None:
        name = name.lower()
        self.external.pop(name, None)
        self.schema_set.discard(name)
