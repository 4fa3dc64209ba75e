"""The control of a cell's comparison: the plain reference put in the
program's place and computed one step below the precision that the
configuration states (int64 sums wrapping as int32 accumulators would,
float64 as float32), judged by the cell's own check against the exact
reference. Every seed's control has to fail the check.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3

Prints one JSON line a seed with the compared numbers beside their
limits. The benchmark's runs do not run it."""
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def control(name: str, seed: int, device: str = "cuda",
            scale: float = 1.0) -> dict:
    """The cell's check of the lower-precision reference, for one seed."""
    import torch
    from portbench import check, harness
    cell = harness.Cell(name)
    tables = harness.to_host(cell.tables(seed, device, scale))
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    exact = harness.references(cell, tables, device)
    lower = harness.references(cell, tables, device, lower=True)
    answers = [(q, rows) for q, rows in lower.items()]
    numbers = check.judge(answers, exact, cell.workload["limits"])
    return {"workload": name, "seed": seed, "check": numbers,
            "failed": not check.passed(numbers)}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    ok = True
    for seed in map(int, args.seeds.split(",")):
        t = time.time()
        out = control(args.workload, seed, args.device)
        out["seconds"] = time.time() - t
        ok &= out["failed"]
        print(json.dumps(out), flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
