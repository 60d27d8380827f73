"""Utilities: logging, text metrics, profiling, keyword detokenization, PCA viz,
penalty scheduler."""
from .keyword_extraction import (  # noqa: F401
    KeywordDecoder,
    extract_keyword_neighbors,
    keyword_retrieval_scores,
)
from .log import MetricsLogger, set_logging, set_metrics_logger  # noqa: F401
from .metric import cer, per, report_bleu, ter, wer  # noqa: F401
from .penalty_scheduler import PenaltyScheduler  # noqa: F401
from .profiling import StepTimer, backward_span, recorded, span, trace  # noqa: F401
from .visualization import draw_embedding_space_pca  # noqa: F401
