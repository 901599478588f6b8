from ventjax_torch.pipeline.result import StudyMetrics, VentResult
from ventjax_torch.pipeline.analyze import (
    analyze_cohort,
    analyze_study,
    build_geometry,
)

__all__ = [
    "StudyMetrics",
    "VentResult",
    "analyze_cohort",
    "analyze_study",
    "build_geometry",
]
