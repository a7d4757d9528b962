"""bn254_tpu_torch.spec — the port's own copy of the pure-int oracle.

``constants.py``, ``field.py`` and ``group.py`` are copies of the JAX
package's ``bn254_tpu/spec/`` modules of the same names (exact-integer
BN254 fields, tower, group law and pairing).  The port keeps its own copy
so that it imports nothing of the JAX package; ``tests/test_torch_pairing.py``
holds the copy equal to the original.  The byte codecs (``codec.py``) are
not copied: they wait for the port's codec slice.
"""

from . import constants, field, group  # noqa: F401
