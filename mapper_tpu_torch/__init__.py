"""mapper_tpu_torch — the read aligner of `mapper_tpu` on PyTorch and CUDA.

The same CLI flags, `Api` and outputs as `mapper_tpu`.  The package stands
alone: it keeps its own copy of `mapper_tpu`'s framework-neutral host code
(sequences, index, candidate generation, exact DP, native C++, writers),
under the same relative paths, and replaces the modules that ran on JAX: the
banded-DP scorer (`align.banded`, with hand-written CUDA kernels in
`align/csrc/`), the batch engine (`batch.engine`) and the CLI (`cli`).
It imports neither JAX nor `mapper_tpu`.
"""

from mapper_tpu_torch.align.params import AlignmentParameters
from mapper_tpu_torch.api import Api, ReferenceIndex

__version__ = "0.1.0"

__all__ = [
    "AlignmentParameters",
    "Api",
    "ReferenceIndex",
    "__version__",
]
