"""Function library: scalar, aggregate and window functions.

Reference parity: `datafusion-functions`, `functions-aggregate` crates
(SURVEY.md §2.3). Return-type signatures live in ``registry.py``; kernel
implementations live in the physical layer (``physical/expr/kernels.py``
for device math, ``host_strings.py`` for dictionary-level string ops).
"""
