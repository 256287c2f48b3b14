"""ECI-Cache core: URD analysis, MRC partitioning, write policies (torch)."""
from repro_torch.core.baselines import SCHEMES, make_manager
from repro_torch.core.batch_sim import (padded_segment_layout,
                                        padded_tape_links, segment_links,
                                        simulate_many)
from repro_torch.core.guard import GuardReport, validate_decision
from repro_torch.core.manager import (AnalyzerDecision, ECICacheManager,
                                      ReconfigEvent, TenantState)
from repro_torch.core.monitor import MonitorResult, analyze_windows
from repro_torch.core.mrc import (BatchedHitRatioFunctions, HitRatioFunction,
                                  build_hit_ratio_function,
                                  build_hit_ratio_functions)
from repro_torch.core.partitioner import (PartitionResult, aggregate_latency,
                                          pgd_solve, two_level_solve)
from repro_torch.core.profile import StageProfile
from repro_torch.core.reuse_distance import (RDResult, auto_sample_rate,
                                             max_rd, sampled_reuse_distances,
                                             shards_keep_mask, shards_salt,
                                             urd_cache_blocks)
from repro_torch.core.simulator import LRUCache, SimResult
from repro_torch.core.trace import (AccessClass, Trace, TraceError,
                                    classify_accesses, prev_next_occurrence,
                                    request_type_mix, validate_trace,
                                    validate_trace_arrays)
from repro_torch.core.write_policy import (WritePolicy, assign_write_policy,
                                           write_ratio)

__all__ = [
    "AccessClass", "AnalyzerDecision", "BatchedHitRatioFunctions",
    "ECICacheManager", "GuardReport", "HitRatioFunction", "LRUCache",
    "MonitorResult", "PartitionResult", "RDResult", "ReconfigEvent",
    "SCHEMES", "SimResult", "StageProfile", "TenantState", "Trace",
    "TraceError", "WritePolicy",
    "aggregate_latency", "analyze_windows", "assign_write_policy",
    "auto_sample_rate", "build_hit_ratio_function",
    "build_hit_ratio_functions", "classify_accesses", "make_manager",
    "max_rd", "padded_segment_layout", "padded_tape_links", "pgd_solve",
    "prev_next_occurrence", "request_type_mix", "sampled_reuse_distances",
    "segment_links", "shards_keep_mask", "shards_salt", "simulate_many",
    "two_level_solve", "urd_cache_blocks", "validate_decision",
    "validate_trace", "validate_trace_arrays", "write_ratio",
]
