"""The benchmark of the PyTorch and CUDA port (`datafusion_tpu_torch`).

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything that belongs to one configuration, traffic mix or per-layer
metric is a file of its own, found by the name that `BENCHMARK.json`
gives it: `configs/<config>.json` and `.py`, `workloads/<cell>.json`,
`queries/<config>/<query>.sql`, `reference/<config>/<query>.py` and
`metrics/<metric>.py`.
"""
