"""ECI-Cache core: URD analysis, MRC partitioning, write policies (torch)."""
from repro_torch.core.baselines import SCHEMES, make_manager
from repro_torch.core.batch_sim import segment_links, simulate_many
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
from repro_torch.core.reuse_distance import (RDResult, max_rd,
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
    "build_hit_ratio_function",
    "build_hit_ratio_functions", "classify_accesses", "make_manager",
    "max_rd", "pgd_solve", "prev_next_occurrence", "request_type_mix",
    "segment_links", "simulate_many",
    "two_level_solve", "urd_cache_blocks", "validate_decision",
    "validate_trace", "validate_trace_arrays", "write_ratio",
]
