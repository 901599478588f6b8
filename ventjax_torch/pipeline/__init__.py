from ventjax_torch.pipeline.result import StudyMetrics, VentResult
from ventjax_torch.pipeline.analyze import (
    analyze_cohort,
    analyze_cohort_grouped,
    analyze_study,
    build_geometry,
    make_analyze_fn,
)

__all__ = [
    "StudyMetrics",
    "VentResult",
    "analyze_cohort",
    "analyze_cohort_grouped",
    "analyze_study",
    "build_geometry",
    "make_analyze_fn",
]
