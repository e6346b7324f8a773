"""NumPy scalar oracles — the semantic ground truth for every kernel.

Each oracle is a direct, readable re-statement of the reference algorithm's
semantics (cited file:line in each module). They are deliberately slow and
sequential; their only job is to pin down tie-breaking, heuristics, and
floating-point behavior so the JAX and CUDA kernels can be tested against them
bit-for-bit (integers) or within the reference's own tolerance (phmm).
"""

from . import phmm as phmm_oracle  # noqa: F401
from . import bsw as bsw_oracle  # noqa: F401
from . import chain as chain_oracle  # noqa: F401
from . import kmer as kmer_oracle  # noqa: F401
