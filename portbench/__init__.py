"""The port's benchmark: one command runs one cell of BENCHMARK.json.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Everything that belongs to one configuration, traffic mix, cell or metric
is a file of its own, found by the name that BENCHMARK.json gives it:
configs/<config>.json, traffic/<traffic>.json, workloads/<cell>.json
(the cell's comparison limits), entries/<entry>.py (the code that runs a kind
of traffic) and metrics/<metric>.py (one reader a metric).
"""
