"""Host frontend: BPE tokenizer (native C++/Python) and WAV I/O.

JAX-free copies of the reference package's tokenizer, native loader and WAV
modules; the mel frontend (clone path) is not ported yet.
"""

from .tokenizer import Tokenizer, find_tokenizer_files
from .wav import StreamingWavWriter, read_wav, resample, write_wav

__all__ = [
    "Tokenizer",
    "find_tokenizer_files",
    "read_wav",
    "write_wav",
    "StreamingWavWriter",
    "resample",
]
