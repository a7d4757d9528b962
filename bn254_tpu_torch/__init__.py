"""bn254_tpu_torch — the PyTorch + CUDA port of bn254_tpu for NVIDIA Hopper
(see README.md).

* host scalar API (this module's re-exports, ``api``): Fr/Fq/Fq2/G1/G2/Gt,
  pairing, pairing_batch, miller_loop_batch, byte & compressed codecs —
  the exact Python-int engine of the port's own ``spec``;
* batched API over those objects (``batch``): pairing_batch,
  pairing_each, msm_g1, msm_g2, scalar_mul_g1, on the card unless the
  caller passes ``device="cpu"``;
* batched tensor path: ``fields`` / ``tower`` / ``groups`` / ``pairing``
  / ``msm`` / ``glv`` / ``codec_device`` on hand-written CUDA kernels.

Importing the package loads no kernel: they are built at first use.
"""

from .api import (  # noqa: F401
    Fr, Fq, Fq2, G1, G2, AffineG1, AffineG2, Gt,
    pairing, pairing_batch, miller_loop_batch,
)
from . import errors  # noqa: F401
from .errors import (  # noqa: F401
    BNError, FieldError, CurveError, GroupError,
)
