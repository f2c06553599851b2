"""Mean host seconds of a wave, in stablelm-3b.serve-longprompt."""
from perfbench.readers import wave_s as read  # noqa: F401
