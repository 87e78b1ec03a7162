from cvsd_tpu_torch.utils.metrics import (  # noqa: F401
    compute_auc_pr,
    compute_auc_roc,
    compute_metrics,
    compute_video_level_metrics,
    find_optimal_threshold,
    pr_curve,
    roc_curve,
)
