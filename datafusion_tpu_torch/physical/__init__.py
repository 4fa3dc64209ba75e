"""Physical layer: executable expressions and operators.

Reference parity: `datafusion/physical-expr` + `datafusion/physical-plan`
(SURVEY.md §2.3-2.4). The compute representation is columnar: dense arrays
plus validity masks, strings as order-preserving dictionary codes. The
general path runs vectorized host kernels (numpy); hot pipelines lower to
jitted JAX device programs (see `datafusion_tpu.device`).
"""
