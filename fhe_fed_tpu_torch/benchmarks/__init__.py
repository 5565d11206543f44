"""Benchmark drivers of the port (model_bench, selective_bench,
train_synth, param_sweep, attack_eval, fedavg_demo, mkhe_bench,
masking_bench, baseline_configs, scaling_virtual), run as `python -m fhe_fed_tpu_torch.benchmarks.<driver>`
on the card unless --device says otherwise; their results go to
build/results_torch/ unless --out names another directory."""
