from cvsd_tpu_torch.sweep.sweep import (  # noqa: F401
    QUICK_SEARCH_SPACE,
    RECOMMENDED_CONFIGS,
    SEARCH_SPACE,
    analyze_results,
    generate_configs,
    run_sweep,
)
