"""The benchmark's command: one run of one cell on the card.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the set-up's split on an earlier line, the compared numbers beside
their limits as the last lines on standard error, and the result as one
JSON object on the last line of standard output. Exits 2 without a result
where the card the cell asks for is missing, and 3 where the process has
loaded JAX or the JAX package.

Where the caller fixes no string-hash seed, the run replaces itself with
the same command under `PYTHONHASHSEED=0`, so that every run orders its
sets of strings alike; its set-up still counts from the first start."""
import os
import sys
import time

T0 = time.time()
if os.environ.get("PYTHONHASHSEED") is None:
    os.execve(sys.executable, [sys.executable, *sys.argv],
              dict(os.environ, PYTHONHASHSEED="0", PORTBENCH_T0=repr(T0)))
T0 = float(os.environ.pop("PORTBENCH_T0", T0))

import argparse  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args()

    import torch
    from portbench import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"available: {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = harness.run(args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda", t0=T0)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"the run loaded {loaded}: the port's runs load neither JAX "
              "nor the JAX package", file=sys.stderr)
        return 3
    harness.report(result)
    return 0


if __name__ == "__main__":
    sys.exit(main())
