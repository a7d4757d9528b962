"""Error taxonomy mirroring the reference crate's value-level enums
(src/lib.rs:102-121, src/groups/mod.rs:88-92, src/arith.rs:195-198) as
Python exceptions.

A copy of bn254_tpu/errors.py, so that the port's host codec
(``spec/codec.py``) raises the same classes without importing the JAX
package; tests/test_torch_pairing.py holds the copy equal to the
original."""


class BNError(Exception):
    """Base class for all bn254_tpu_torch errors."""


class FieldError(BNError):
    """Field decode/construct errors (lib.rs:102-107)."""


class InvalidSliceLength(FieldError):
    pass


class InvalidU512Encoding(FieldError):
    pass


class NotMemberFieldError(FieldError):
    """Value not a canonical member of the field."""


class CurveError(BNError):
    """Curve decode errors (lib.rs:109-115)."""


class InvalidEncoding(CurveError):
    pass


class NotMemberCurveError(CurveError):
    """Point not on the curve / not in the subgroup."""


class ToAffineConversion(CurveError):
    """Point at infinity where an affine point was required."""


class GroupError(BNError):
    """Affine construction errors (groups/mod.rs:88-92)."""


class NotOnCurve(GroupError):
    pass


class NotInSubgroup(GroupError):
    pass
