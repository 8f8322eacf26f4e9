"""Host frontend: BPE tokenizer (native C++/Python) and WAV I/O.

JAX-free copies of the reference package's tokenizer, native loader and WAV
modules, and the log-mel frontend of the voice-clone path.
"""

from .mel import log_mel
from .tokenizer import Tokenizer, find_tokenizer_files
from .wav import StreamingWavWriter, read_wav, resample, write_wav

__all__ = [
    "Tokenizer",
    "find_tokenizer_files",
    "read_wav",
    "write_wav",
    "StreamingWavWriter",
    "resample",
    "log_mel",
]
