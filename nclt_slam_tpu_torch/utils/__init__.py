from nclt_slam_tpu_torch.utils.profiling import RateCounter, profile_trace, rollout_stats

__all__ = ["RateCounter", "profile_trace", "rollout_stats"]
