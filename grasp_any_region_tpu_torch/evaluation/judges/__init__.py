from .client import JudgeClient, JudgeConfig  # noqa: F401
from .dlc_judge import judge_dlc, parse_pred  # noqa: F401
from .garbench_judge import judge_detailed, judge_simple  # noqa: F401
from .pairwise_judge import parse_scores, review_pairs, summarize  # noqa: F401
