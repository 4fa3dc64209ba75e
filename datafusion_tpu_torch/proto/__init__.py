"""Plan serialization.

Reference parity: `datafusion-proto` (`proto/proto/datafusion.proto:33-61`,
bytes roundtrip `proto/src/bytes/`) — the substrate for shipping plans to
other processes (multi-host SPMD launch / Ballista-style schedulers). The
wire format here is JSON (schema-stable dicts); the reference's guarantee
that matters — every logical plan/expression node round-trips — is matched
and tested.
"""
from .logical import (  # noqa: F401
    expr_from_dict, expr_to_dict, plan_from_dict, plan_to_dict,
    plan_from_json, plan_to_json,
)
