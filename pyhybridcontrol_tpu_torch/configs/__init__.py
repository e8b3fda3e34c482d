from pyhybridcontrol_tpu_torch.configs.benchmarks import (
    BENCHMARK_CONFIGS,
    BenchmarkConfig,
    get_config,
)

__all__ = ["BENCHMARK_CONFIGS", "BenchmarkConfig", "get_config"]
