"""Pod worker process: binds a TCP port, prints it on stdout, then
serves the coordinator protocol (parallel/pod.py): REGISTER table
shards, EXECUTE shipped physical-plan JSON against its own catalog,
reply with result batches. One process == one "host" of the pod; its
own session on its device handles intra-host parallelism.

Run: python -m datafusion_tpu_torch.parallel.pod_worker [--device cuda|cpu]

The session takes the card (`--device cuda`, the default) unless it is
given the CPU; it opens before the port is printed, so a worker asked for
a card it does not have exits at once.
"""
from __future__ import annotations

import socket
import sys
import traceback

from .pod import batch_from_wire, batch_to_wire, recv_msg, send_msg


def _serve(conn: socket.socket, ctx) -> None:
    from ..datasource.memory import MemTable
    from ..physical.plan.base import concat_batches
    from ..proto.physical import phys_from_dict
    from ..runtime import TaskContext

    while True:
        meta, blobs = recv_msg(conn)
        cmd = meta.get("cmd")
        try:
            if cmd == "shutdown":
                send_msg(conn, {"ok": True}, [])
                return
            if cmd == "register":
                batch = batch_from_wire(meta["batch"], blobs)
                try:
                    ctx.deregister_table(meta["name"])
                except Exception:  # noqa: BLE001
                    pass
                ctx.register_table(meta["name"],
                                   MemTable(batch.schema, [[batch]]))
                send_msg(conn, {"ok": True}, [])
            elif cmd == "register_multi":
                batches = []
                off = 0
                for bm in meta["batches"]:
                    nb = sum(1 for c in bm["cols"]
                             if c["np"] != "json") + \
                        sum(1 for c in bm["cols"] if c["validity"])
                    batches.append(batch_from_wire(bm, blobs[off:off + nb]))
                    off += nb
                try:
                    ctx.deregister_table(meta["name"])
                except Exception:  # noqa: BLE001
                    pass
                schema = batches[0].schema
                ctx.register_table(meta["name"],
                                   MemTable(schema, [batches]))
                send_msg(conn, {"ok": True}, [])
            elif cmd == "execute":
                # NOTE: shipped fragments run as-is — a lone PARTIAL
                # aggregate must emit accumulator STATES, which the
                # device-fusion rules would collapse to final values
                plan = phys_from_dict(meta["plan"], ctx)
                tctx = TaskContext(ctx.config.options, ctx.runtime)
                n_parts = plan.output_partitioning().n
                parts_meta = []
                out_blobs = []
                for p in range(n_parts):
                    batches = [b for b in plan.execute(p, tctx)
                               if b.num_rows]
                    if batches:
                        b = concat_batches(plan.schema(), batches)
                    else:
                        from ..common.batch import Batch
                        b = Batch(plan.schema(), [
                            _empty_col(f) for f in plan.schema()], 0)
                    bm, bb = batch_to_wire(b)
                    parts_meta.append({"batch": bm, "nblobs": len(bb)})
                    out_blobs.extend(bb)
                send_msg(conn, {"ok": True, "parts": parts_meta},
                         out_blobs)
            else:
                send_msg(conn, {"error": f"unknown cmd {cmd}"}, [])
        except Exception:  # noqa: BLE001
            send_msg(conn, {"error": traceback.format_exc()}, [])


def _empty_col(f):
    import numpy as np

    from ..common.column import Column, Dictionary
    dd = f.dtype.device_dtype() if hasattr(f.dtype, "device_dtype") else None
    np_dt = np.dtype(dd) if dd is not None else np.int64
    dic = Dictionary(np.array([], dtype=object)) if f.dtype.is_string \
        else None
    data = np.zeros(0, np.int32 if dic is not None else np_dt)
    return Column(f.dtype, data, None, dic)


def main(argv=None) -> None:
    import argparse

    from ..api.context import SessionContext
    p = argparse.ArgumentParser(
        prog="datafusion_tpu_torch.parallel.pod_worker")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ctx = SessionContext(p.parse_args(argv).device)
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.bind(("127.0.0.1", 0))
    srv.listen(1)
    print(srv.getsockname()[1], flush=True)
    conn, _ = srv.accept()
    try:
        _serve(conn, ctx)
    finally:
        conn.close()
        srv.close()
        sys.exit(0)


if __name__ == "__main__":
    main()
