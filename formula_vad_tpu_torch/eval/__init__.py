from . import evaluator, formats, report, statistics  # noqa: F401
from .evaluator import Evaluator, SpeechSegment, init_and_run  # noqa: F401
