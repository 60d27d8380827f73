"""Utilities: logging, text metrics, profiling, keyword detokenization, PCA viz."""
from .metric import cer, per, report_bleu, ter, wer  # noqa: F401
from .profiling import StepTimer, annotate, trace  # noqa: F401
