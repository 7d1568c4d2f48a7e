from repro_torch.kernels.consensus_stats.kernel import (HELD_MAX_WORKERS, Plan,
                                                        consensus_stats, plan)
from repro_torch.kernels.consensus_stats.ref import (column_sums,
                                                     consensus_stats_reference)

__all__ = ["HELD_MAX_WORKERS", "Plan", "consensus_stats", "plan", "column_sums",
           "consensus_stats_reference"]
