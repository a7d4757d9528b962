"""bn254_tpu_torch — the PyTorch + CUDA port of bn254_tpu for NVIDIA Hopper
(see README.md).

* host scalar API (this module's re-exports, ``api``): Fr/Fq/Fq2/G1/G2/Gt,
  pairing, pairing_batch, miller_loop_batch, byte & compressed codecs —
  exact Python ints, its hot paths on the native host engine (``native``,
  C built at the first call; ``BN254_NO_NATIVE=1`` runs the port's own
  ``spec`` instead);
* batched API over those objects (``batch``): pairing_batch,
  pairing_each, msm_g1, msm_g2, scalar_mul_g1, on the card unless the
  caller passes ``device="cpu"``;
* batched tensor path: ``fields`` / ``tower`` / ``groups`` /
  ``pairing_torch`` / ``msm`` / ``glv`` / ``codec_device`` on hand-written
  CUDA kernels; ``parallel``: the sharded pairing and MSM over
  torch.distributed;
* entry points and workloads: ``entry`` (``entry()``,
  ``dryrun_multichip``), ``shootout``, ``examples.dh`` /
  ``examples.joux``.

Importing the package loads no kernel and builds nothing: the kernels and
the host engine are built at first use.
"""

__version__ = "0.1.0"

from .api import (  # noqa: F401
    Fr, Fq, Fq2, G1, G2, AffineG1, AffineG2, Gt,
    pairing, pairing_batch, miller_loop_batch,
)
from . import errors  # noqa: F401
from .errors import (  # noqa: F401
    BNError, FieldError, CurveError, GroupError,
)
