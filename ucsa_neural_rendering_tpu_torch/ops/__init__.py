from .aabb import near_far_from_aabb
from .compositing import (composite, composite_bwd, composite_bwd_plain,
                          composite_fwd, composite_fwd_plain, composite_rays,
                          composite_weights)
from .occupancy import occ_grid_update, occ_grid_update_plain, update_grid
from .placement import (importance_resample, importance_resample_plain,
                        occ_placement, occ_placement_plain)
from .sampling import sample_pdf, stratified_samples

__all__ = [
    "near_far_from_aabb", "composite", "composite_bwd", "composite_bwd_plain",
    "composite_fwd", "composite_fwd_plain", "composite_rays",
    "composite_weights", "occ_grid_update", "occ_grid_update_plain",
    "update_grid", "importance_resample", "importance_resample_plain",
    "occ_placement", "occ_placement_plain", "sample_pdf",
    "stratified_samples",
]
