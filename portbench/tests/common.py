"""Sizes and helpers the benchmark's tests share."""
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
CELLS = ("tpch-sf10-chains", "tpch-sf10-scan", "clickbench-hits-sums")
# scales at which the port's plain CPU versions run a cell in seconds
SCALE = {"tpch-sf10-chains": 2e-4, "tpch-sf10-scan": 2e-4,
         "clickbench-hits-sums": 1e-4}
BIG_SEED = 2 ** 31 + 12345
