"""The reference's examples on the port's scalar API: ``dh`` (three-party
Diffie-Hellman over G1) and ``joux`` (one-round three-party key agreement
through the pairing).

    python -m bn254_tpu_torch.examples.dh
    python -m bn254_tpu_torch.examples.joux
"""
