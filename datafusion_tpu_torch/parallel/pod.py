"""Multi-process execution pod: physical plan fragments shipped as JSON,
shuffle partitions moved host-to-host over TCP sockets.

This is the DCN half of the distributed story (SURVEY §5.8): each worker
is its own PROCESS with its own catalog (its shard of every table) and
its own session on its device; intra-worker parallelism stays the mesh's
collectives (parallel/exchange.py), while cross-worker movement — the
part that cannot ride one process group — travels over sockets, as
between the hosts of a cluster.

Reference parity: the `datafusion-proto` plan-shipping layer + the
Ballista executor/shuffle model (`datafusion.proto:713-760`; the
reference itself delegates multi-host to Ballista). The coordinator
plans SQL normally, splits at the Partial->Repartition->Final aggregate
exchange, ships stage 1 to every worker (each binds the scan to ITS
shard), routes the hash partitions worker-to-worker, ships stage 2, and
runs any remaining plan (sort/limit/projection) locally.

Wire format: length-prefixed JSON metadata + raw numpy buffers (no
pickle); dictionary values travel as JSON string lists.
"""
from __future__ import annotations

import json
import os
import socket
import struct
import subprocess
import sys
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..common.batch import Batch
from ..common.column import Column, Dictionary
from ..proto.physical import (phys_to_dict, schema_from_dict,
                              schema_to_dict)


# ---- wire helpers ---------------------------------------------------------

def send_msg(sock: socket.socket, meta: dict, blobs: List[bytes]) -> None:
    mb = json.dumps(meta).encode()
    sock.sendall(struct.pack(">II", len(mb), len(blobs)) + mb)
    for b in blobs:
        sock.sendall(struct.pack(">Q", len(b)) + bytes(b))


def _recv_exact(sock: socket.socket, n: int) -> bytes:
    out = bytearray()
    while len(out) < n:
        chunk = sock.recv(n - len(out))
        if not chunk:
            raise ConnectionError("pod peer closed")
        out.extend(chunk)
    return bytes(out)


def recv_msg(sock: socket.socket) -> Tuple[dict, List[bytes]]:
    mlen, nblobs = struct.unpack(">II", _recv_exact(sock, 8))
    meta = json.loads(_recv_exact(sock, mlen).decode())
    blobs = []
    for _ in range(nblobs):
        (blen,) = struct.unpack(">Q", _recv_exact(sock, 8))
        blobs.append(_recv_exact(sock, blen))
    return meta, blobs


def batch_to_wire(b: Batch) -> Tuple[dict, List[bytes]]:
    meta = {"schema": schema_to_dict(b.schema), "n": b.num_rows,
            "cols": []}
    blobs: List[bytes] = []
    for c in b.columns:
        data = np.ascontiguousarray(c.data_host()[:b.num_rows])
        cm = {"np": data.dtype.str, "validity": False, "dict": None}
        if data.dtype == object:
            cm["np"] = "json"
            cm["data_json"] = [None if v is None else str(v)
                               for v in data]
        else:
            blobs.append(data.tobytes())
        v = c.validity_host()
        if v is not None:
            cm["validity"] = True
            blobs.append(np.ascontiguousarray(
                v[:b.num_rows]).astype(np.uint8).tobytes())
        if c.dictionary is not None:
            cm["dict"] = [str(x) for x in c.dictionary.values]
        meta["cols"].append(cm)
    return meta, blobs


def batch_from_wire(meta: dict, blobs: List[bytes]) -> Batch:
    schema = schema_from_dict(meta["schema"])
    n = meta["n"]
    cols = []
    bi = 0
    for f, cm in zip(schema, meta["cols"]):
        if cm["np"] == "json":
            data = np.array(cm["data_json"], dtype=object)
        else:
            data = np.frombuffer(blobs[bi], dtype=np.dtype(cm["np"]))
            data = data.copy()
            bi += 1
        validity = None
        if cm["validity"]:
            validity = np.frombuffer(blobs[bi], dtype=np.uint8) \
                .astype(bool).copy()
            bi += 1
        dic = None
        if cm["dict"] is not None:
            dic = Dictionary(np.array(cm["dict"], dtype=object))
        cols.append(Column(f.dtype, data, validity, dic))
    return Batch(schema, cols, n)


# ---- coordinator ----------------------------------------------------------

class PodWorkerHandle:
    def __init__(self, proc: subprocess.Popen, sock: socket.socket):
        self.proc = proc
        self.sock = sock

    def call(self, meta: dict, blobs: List[bytes] = ()) \
            -> Tuple[dict, List[bytes]]:
        send_msg(self.sock, meta, list(blobs))
        reply, rblobs = recv_msg(self.sock)
        if reply.get("error"):
            raise RuntimeError(f"pod worker error: {reply['error']}")
        return reply, rblobs


class LocalPod:
    """Coordinator for N worker processes on this host (the CI-scale
    stand-in for N remote hosts; the wire protocol is identical). Each
    worker's session takes `device`: the card unless it is given the CPU,
    where each kernel runs its plain PyTorch version; with no card, a
    worker asked for it fails to start."""

    def __init__(self, n_workers: int = 2, device: str = "cuda"):
        self.workers: List[PodWorkerHandle] = []
        env = dict(os.environ)
        root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = root + os.pathsep + env.get("PYTHONPATH", "")
        # the workers start together; each prints its port once its
        # session is open
        procs = [subprocess.Popen(
            [sys.executable, "-m", "datafusion_tpu_torch.parallel.pod_worker",
             "--device", str(device)], stdout=subprocess.PIPE, env=env)
            for _ in range(n_workers)]
        for i, proc in enumerate(procs):
            line = proc.stdout.readline().strip()
            if not line:
                for rest in procs[i + 1:]:
                    rest.kill()
                    rest.wait()
                proc.wait(timeout=60)
                self.close()
                raise RuntimeError(
                    f"pod worker on {device} exited with code "
                    f"{proc.returncode} before it listened")
            sock = socket.create_connection(("127.0.0.1", int(line)),
                                            timeout=60)
            self.workers.append(PodWorkerHandle(proc, sock))

    def close(self) -> None:
        for w in self.workers:
            try:
                send_msg(w.sock, {"cmd": "shutdown"}, [])
                w.sock.close()
            except OSError:
                pass
            w.proc.wait(timeout=30)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- data distribution --------------------------------------------
    def register_sharded(self, name: str, batch: Batch) -> None:
        """Split one host batch row-wise into |workers| shards and
        register each under `name` on its worker."""
        n = batch.num_rows
        k = len(self.workers)
        per = (n + k - 1) // k
        for i, w in enumerate(self.workers):
            shard = batch.slice_host(i * per, max(
                min(per, n - i * per), 0))
            meta, blobs = batch_to_wire(shard)
            w.call({"cmd": "register", "name": name, "batch": meta}, blobs)

    def register_shards(self, name: str, shards: List[Batch]) -> None:
        assert len(shards) == len(self.workers)
        for w, shard in zip(self.workers, shards):
            meta, blobs = batch_to_wire(shard)
            w.call({"cmd": "register", "name": name, "batch": meta}, blobs)

    # -- distributed execution ----------------------------------------
    def sql_distributed(self, ctx, sql: str) -> Batch:
        """Run an aggregation SQL across the pod: plan on the
        coordinator `ctx` (which holds same-schema tables), split at the
        Partial->Repartition(Hash)->FinalPartitioned exchange, ship
        stage 1, shuffle worker-to-worker by hash partition, ship
        stage 2, finish the remaining plan locally."""
        from ..physical.plan.aggregate import AggregateExec, AggregateMode
        from ..physical.plan.repartition import RepartitionExec
        from ..physical.plan.scan import MemoryExec
        from ..datasource.memory import MemTable

        frame = ctx.sql(sql)
        plan = _unfuse(frame.create_physical_plan())

        # find the Final(Partitioned) aggregate over a hash Repartition
        target = None

        def find(node):
            nonlocal target
            if isinstance(node, AggregateExec) and node.mode in (
                    AggregateMode.FINAL_PARTITIONED, AggregateMode.FINAL,
                    AggregateMode.SINGLE):
                target = node
                return
            for c in node.children():
                find(c)

        find(plan)
        if target is None:
            raise NotImplementedError(
                "pod execution needs an aggregation query")

        if target.mode == AggregateMode.SINGLE:
            # single-partition coordinator plan: synthesize the two-phase
            # split (the pod IS the reason to go two-phase)
            from ..physical.plan.projection import CoalescePartitionsExec
            from ..physical.expressions import ColumnExpr
            child = target.input
            if isinstance(child, CoalescePartitionsExec):
                child = child.input
            partial = AggregateExec(AggregateMode.PARTIAL,
                                    target.group_exprs, target.aggr_exprs,
                                    child)
            groups_n = len(target.group_exprs)
            hash_exprs = [ColumnExpr(i, n, e.out_type)
                          for i, (e, n) in enumerate(target.group_exprs)]
            from ..physical.plan.base import Partitioning
            exchange = RepartitionExec(
                partial,
                Partitioning.hash(hash_exprs, len(self.workers)))
            final_groups = [(ColumnExpr(i, n, e.out_type), n)
                            for i, (e, n) in
                            enumerate(target.group_exprs)]
            final = AggregateExec(AggregateMode.FINAL_PARTITIONED,
                                  final_groups, target.aggr_exprs,
                                  exchange)
        else:
            final = target
            exchange = final.input
            if not isinstance(exchange, RepartitionExec):
                raise NotImplementedError("expected hash exchange under "
                                          "the final aggregate")
            partial = exchange.input

        table_names = self._table_names(ctx)
        # ship Repartition(partial) with the pod's worker count so every
        # worker hash-partitions its partial output |workers| ways
        from ..physical.plan.base import Partitioning
        from ..physical.expressions import ColumnExpr
        hash_exprs = (exchange.partitioning.exprs
                      if isinstance(exchange, RepartitionExec) and
                      exchange.partitioning.exprs else
                      [ColumnExpr(i, n, e.out_type) for i, (e, n) in
                       enumerate(partial.group_exprs)])
        ship1 = RepartitionExec(
            partial, Partitioning.hash(hash_exprs, len(self.workers)))
        stage1_json = phys_to_dict(ship1, table_names)

        # stage 1 on every worker: returns |workers| hash partitions
        shuffled: List[List[Tuple[dict, List[bytes]]]] = \
            [[] for _ in self.workers]
        for w in self.workers:
            reply, blobs = w.call({"cmd": "execute", "plan": stage1_json,
                                   "collect": "partitions"})
            off = 0
            for p, bm in enumerate(reply["parts"]):
                nb = bm["nblobs"]
                shuffled[p].append((bm["batch"], blobs[off:off + nb]))
                off += nb

        # route partition p to worker p; register as the shuffle table
        for p, w in enumerate(self.workers):
            w.call({"cmd": "register_multi", "name": "__pod_shuffle",
                    "batches": [m for m, _ in shuffled[p]]},
                   [b for _, bl in shuffled[p] for b in bl])

        # stage 2: final aggregate over the local shuffle table
        from ..proto.physical import _agg_to_dict, pexpr_to_dict
        stage2_json = {
            "k": "agg", "mode": final.mode.name,
            "groups": [[pexpr_to_dict(e), n]
                       for e, n in final.group_exprs],
            "aggs": [_agg_to_dict(a) for a in final.aggr_exprs],
            "in": {"k": "mem", "table": "__pod_shuffle",
                   "projection": None, "limit": None}}

        outs: List[Batch] = []
        for w in self.workers:
            reply, blobs = w.call({"cmd": "execute", "plan": stage2_json,
                                   "collect": "all"})
            off = 0
            for bm in reply["parts"]:
                nb = bm["nblobs"]
                outs.append(batch_from_wire(bm["batch"],
                                            blobs[off:off + nb]))
                off += nb

        from ..physical.plan.base import concat_batches
        result = concat_batches(final.schema(),
                                [b for b in outs if b.num_rows])

        # run the remaining coordinator plan above the aggregate (sort,
        # projection, limit) over the collected result
        remainder = _swap_subtree(plan, target, MemoryExec(
            MemTable(final.schema(), [[result]])))
        from ..physical.plan.base import collect_batch
        return collect_batch(remainder, ctx.task_context())

    @staticmethod
    def _table_names(ctx) -> Dict[int, str]:
        out = {}
        cat = ctx._current_catalog()
        for sname in cat.schema_names():
            sp = cat.schema(sname)
            for tname in sp.table_names():
                out[id(sp.table(tname))] = tname
        return out


def _unfuse(p):
    """Undo local device fusions for plan SHIPPING: each worker re-fuses
    for its own chip after deserialization."""
    from ..physical.plan.device_aggregate import TorchDeviceExec
    if isinstance(p, TorchDeviceExec):
        return _unfuse(p.fallback)
    kids = p.children()
    if not kids:
        return p
    return p.with_children([_unfuse(c) for c in kids])


def _swap_subtree(plan, target, replacement):
    if plan is target:
        return replacement
    kids = plan.children()
    if not kids:
        return plan
    return plan.with_children(
        [_swap_subtree(c, target, replacement) for c in kids])
