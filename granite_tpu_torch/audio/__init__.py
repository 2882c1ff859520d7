from .dsp import one_pole_filter, sinc_resample
from .mixer import (
    Mixer, MixerStream, SineStream, StreamState, WavStream,
)
from .backend import AudioBackend, NullBackend, WavFileBackend
