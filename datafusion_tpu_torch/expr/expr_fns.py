"""Public expression-building helpers (`datafusion_tpu.col`, `lit`, ...)."""
from .expr import col, lit  # noqa: F401
