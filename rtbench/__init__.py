"""tpurt_torch's benchmark: ``python3 rtbench/run.py --workload <name>
--seed <n> --seconds <s> --trace <0|1>`` runs one cell of BENCHMARK.json
once on one card and prints its result line."""
