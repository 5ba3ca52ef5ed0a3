from .model import (SAMConfig, init_sam_params, predict_mask, sam_vit_b, sam_vit_h,  # noqa: F401
                    sam_vit_l)
from .pipeline import SamPredictor, draw_mask_overlay, mask_contours  # noqa: F401
