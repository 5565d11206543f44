"""The benchmark of fhe_fed_tpu_torch: secure-FedAvg rounds on one H100.

BENCHMARK.json at the checkout's root names the cells; each is a
configuration (configs/<name>.json) under a traffic mix
(traffic/<mix>.json), and each metric is read by metrics/<name>.py. One
run of a cell: `python3 -m fedbench.run --workload <name> --seed <n>
--seconds <s> --trace <0|1>`. The yardstick (the plain reference, the
frozen wire formats and the comparison that decides `correct`) is in
reference/, which imports nothing of the program. `python3 -m
fedbench.control` gives the readings the limits were set from.
"""
