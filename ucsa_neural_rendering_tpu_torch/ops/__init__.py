from .aabb import near_far_from_aabb
from .compositing import (composite, composite_fwd, composite_fwd_plain,
                          composite_weights)
from .placement import (importance_resample, importance_resample_plain,
                        occ_placement, occ_placement_plain)
from .sampling import sample_pdf, stratified_samples

__all__ = [
    "near_far_from_aabb", "composite", "composite_fwd", "composite_fwd_plain",
    "composite_weights", "importance_resample", "importance_resample_plain",
    "occ_placement", "occ_placement_plain", "sample_pdf",
    "stratified_samples",
]
