"""ECI-Cache core: URD analysis, MRC partitioning, write policies (torch)."""
from repro_torch.core.baselines import SCHEMES, GlobalLRUManager, make_manager
from repro_torch.core.batch_sim import (padded_segment_layout,
                                        padded_tape_links,
                                        reuse_distances_fast, segment_links,
                                        simulate_batch, simulate_many,
                                        stack_distances)
from repro_torch.core.characterize import (PhaseDetector, PhaseEvent,
                                           WindowFeatures,
                                           characterize_trace,
                                           characterize_windows)
from repro_torch.core.device_pipeline import (DeviceWindowPipeline,
                                              WindowDecision,
                                              greedy_walk_device,
                                              monitor_window_device,
                                              transfer_sanitizer)
from repro_torch.core.faults import (FAULT_KINDS, FaultPlan, FaultSpec,
                                     InjectedFault)
from repro_torch.core.guard import GuardReport, validate_decision
from repro_torch.core.manager import (AnalyzerDecision, DegradeEvent,
                                      ECICacheManager, ReconfigEvent,
                                      TenantState)
from repro_torch.core.monitor import MonitorResult, analyze_windows
from repro_torch.core.mrc import (BatchedHitRatioFunctions, HitRatioFunction,
                                  build_hit_ratio_function,
                                  build_hit_ratio_functions)
from repro_torch.core.partitioner import (PartitionResult, aggregate_latency,
                                          greedy_allocate, pgd_solve,
                                          two_level_solve)
from repro_torch.core.profile import StageProfile
from repro_torch.core.reuse_distance import (RDResult, auto_sample_rate,
                                             max_rd, reuse_distances,
                                             reuse_distances_vectorized,
                                             sampled_reuse_distances,
                                             shards_keep_mask, shards_salt,
                                             urd_cache_blocks)
from repro_torch.core.simulator import (LRUCache, SimResult,
                                       rebalance_levels, simulate)
from repro_torch.core.trace import (AccessClass, Trace, TraceError,
                                    classify_accesses, prev_next_occurrence,
                                    request_type_mix, total_cache_writes_wb,
                                    validate_trace, validate_trace_arrays)
from repro_torch.core.write_policy import (WritePolicy, assign_write_policy,
                                           assign_write_policy_levels,
                                           write_ratio)

__all__ = [
    "AccessClass", "AnalyzerDecision", "BatchedHitRatioFunctions",
    "DegradeEvent", "DeviceWindowPipeline", "ECICacheManager",
    "FAULT_KINDS", "FaultPlan", "FaultSpec", "GlobalLRUManager",
    "GuardReport", "HitRatioFunction", "InjectedFault", "LRUCache",
    "MonitorResult", "PartitionResult", "PhaseDetector", "PhaseEvent",
    "RDResult", "ReconfigEvent", "SCHEMES", "SimResult", "StageProfile",
    "TenantState", "Trace", "TraceError", "WindowDecision",
    "WindowFeatures", "WritePolicy",
    "aggregate_latency", "analyze_windows", "assign_write_policy",
    "assign_write_policy_levels", "auto_sample_rate",
    "build_hit_ratio_function", "build_hit_ratio_functions",
    "characterize_trace", "characterize_windows", "classify_accesses",
    "greedy_allocate", "greedy_walk_device", "make_manager", "max_rd",
    "monitor_window_device", "padded_segment_layout",
    "padded_tape_links", "pgd_solve", "prev_next_occurrence",
    "rebalance_levels", "request_type_mix", "reuse_distances",
    "reuse_distances_fast", "reuse_distances_vectorized",
    "sampled_reuse_distances", "segment_links", "shards_keep_mask",
    "shards_salt", "simulate", "simulate_batch", "simulate_many",
    "stack_distances", "total_cache_writes_wb", "transfer_sanitizer",
    "two_level_solve",
    "urd_cache_blocks", "validate_decision", "validate_trace",
    "validate_trace_arrays", "write_ratio",
]
