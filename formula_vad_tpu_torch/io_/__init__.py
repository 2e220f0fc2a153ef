from . import audio, ogg, wav  # noqa: F401
from .audio import AudioBuffer, AudioSource  # noqa: F401
