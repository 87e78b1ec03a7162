from cvsd_tpu_torch.config.config import (  # noqa: F401
    Config,
    apply_overrides,
    get_default_config,
    load_config,
    merge_configs,
    save_config,
    validate_config,
)
