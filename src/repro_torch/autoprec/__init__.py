"""Hardware-aware automatic mixed-precision search (port of
``repro.autoprec``; the same exports).

Closes the loop the paper's accelerator exists for: the hardware serves any
even per-layer weight width from one preloaded superplane store, and this
package decides WHICH widths, automatically:

    model --(sensitivity: real quantization path)--> per-layer divergences
          --(cost: hwmodel cycles/energy per token)--> priced candidates
          --(search: greedy + differentiable relaxation)--> Pareto front
          --(schedule_io: JSON PrecisionSchedule)--> ServeEngine

Entry points: :func:`profile_sensitivity` / :func:`measure_divergence`
(measured through plane-prefix truncation, never a proxy),
:class:`CostModel` (modeled cycles — the paper's axis, not average bits),
:func:`search` / :func:`greedy_search` / :func:`relaxed_search` /
:func:`pareto_front`, and :func:`save_schedule` / :func:`load_schedule` /
:func:`schedule_from_results`.  ``python -m repro_torch.launch.autoprec``
drives the whole pipeline on the card and writes a schedule that
``repro_torch.launch.serve --schedule-file`` serves.
"""
from repro_torch.autoprec.cost import Assignment, CostModel
from repro_torch.autoprec.schedule_io import (load_schedule,
                                              load_schedule_with_meta,
                                              result_to_meta, save_schedule,
                                              schedule_from_dict,
                                              schedule_from_results,
                                              schedule_to_dict)
from repro_torch.autoprec.search import (EVEN_CHOICES, SearchResult,
                                         default_lambdas, greedy_search,
                                         greedy_trajectory, pareto_front,
                                         predicted_divergence,
                                         relaxed_search, search)
from repro_torch.autoprec.sensitivity import (SensitivityProfile,
                                              measure_divergence,
                                              measure_tiers,
                                              profile_sensitivity,
                                              random_calibration)

__all__ = [
    "Assignment", "CostModel", "EVEN_CHOICES", "SearchResult",
    "SensitivityProfile", "default_lambdas", "greedy_search",
    "greedy_trajectory", "load_schedule", "load_schedule_with_meta",
    "measure_divergence", "measure_tiers", "pareto_front",
    "predicted_divergence", "profile_sensitivity", "random_calibration",
    "relaxed_search", "result_to_meta", "save_schedule",
    "schedule_from_dict", "schedule_from_results", "schedule_to_dict",
    "search",
]
