from .coco import COCO  # noqa: F401
from .dlc import run_dlc  # noqa: F401
from .engine import BatchedCaptioner  # noqa: F401
from .ferret import run_ferret  # noqa: F401
from .garbench import run_garbench, score_vqa  # noqa: F401
from .mdvp import run_mdvp, transfer  # noqa: F401
