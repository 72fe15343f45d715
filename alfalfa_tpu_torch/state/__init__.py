from .decoder_state import (DecoderState, Segmentation, FilterAdjustments,
                            ProbabilityTables, References)
from .hashing import hash_combine, hash_range, decoder_hash
