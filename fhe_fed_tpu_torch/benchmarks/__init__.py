"""Benchmark drivers of the port (model_bench, selective_bench), run as
`python -m fhe_fed_tpu_torch.benchmarks.<driver>`; their results go to
build/results_torch/ unless --out names another directory."""
