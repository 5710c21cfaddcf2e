"""rowbowt-tpu: a batched pangenome r-index query engine in JAX, run on NVIDIA GPUs.

A jax/XLA framework with the capabilities of the CPU reference `alshai/rowbowt`
(run-length BWT count / locate / marker-genotyping queries over a pangenome
index), redesigned for an accelerator: all succinct-structure operations become
batched searchsorted+gather over dense sorted tables, and thousands of reads run
backward search in lockstep inside jit'd lax loops.

See DESIGN.md for the architecture and SURVEY.md for the reference analysis.
"""

import jax as _jax

# Packed 64-bit markers (seq:15|pos:40|allele:8) and >2^31 text positions need
# real int64 on device; all hot-path arrays are explicitly int32 when the index
# fits, so this costs nothing there.
_jax.config.update("jax_enable_x64", True)

from rowbowt_tpu.alphabet import Alphabet, TERM_BYTE, SEP_BYTE
from rowbowt_tpu.index import RbtIndex

__version__ = "0.1.0"

__all__ = [
    "Alphabet",
    "RbtIndex",
    "TERM_BYTE",
    "SEP_BYTE",
    "__version__",
]
