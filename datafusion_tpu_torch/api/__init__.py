"""User-facing API: SessionContext + DataFrame.

Reference parity: `datafusion/core/src/execution/context/` and
`dataframe/mod.rs`.
"""
from .context import SessionConfig, SessionContext  # noqa: F401
from .dataframe import DataFrame  # noqa: F401
