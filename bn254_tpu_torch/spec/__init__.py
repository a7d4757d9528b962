"""bn254_tpu_torch.spec — the port's own copy of the pure-int oracle.

``constants.py``, ``field.py``, ``group.py`` and ``codec.py`` are copies
of the JAX package's ``bn254_tpu/spec/`` modules of the same names
(exact-integer BN254 fields, tower, group law and pairing, and the byte
codecs with the reference's error taxonomy, ``bn254_tpu_torch/errors.py``).
The port keeps its own copy so that it imports nothing of the JAX package;
``tests/test_torch_pairing.py`` holds the copy equal to the original.
"""

from . import constants, field, group, codec  # noqa: F401
