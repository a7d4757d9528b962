"""Three-party Diffie-Hellman key exchange over G1 (two rounds), on the
port's scalar API — port form of examples/dh.py.

Executable acceptance test of scalar multiplication end to end; the
behavioral model is the reference's examples/dh.rs:6-31.

    python -m bn254_tpu_torch.examples.dh
"""

import random

from bn254_tpu_torch import Fr, G1


def main(rng=None):
    """Run the exchange with secret keys drawn from rng (a random.Random;
    the module's generator where None); returns the shared secret."""
    rng = rng if rng is not None else random.Random()
    alice_sk = Fr.random(rng)
    bob_sk = Fr.random(rng)
    carol_sk = Fr.random(rng)

    alice_pk = G1.one() * alice_sk
    bob_pk = G1.one() * bob_sk
    carol_pk = G1.one() * carol_sk

    # Round one
    alice_dh_1 = bob_pk * carol_sk
    bob_dh_1 = carol_pk * alice_sk
    carol_dh_1 = alice_pk * bob_sk

    # Round two
    alice_dh_2 = alice_dh_1 * alice_sk
    bob_dh_2 = bob_dh_1 * bob_sk
    carol_dh_2 = carol_dh_1 * carol_sk

    assert alice_dh_2 == bob_dh_2 == carol_dh_2
    print("dh: three-party shared secret agrees")
    return alice_dh_2


if __name__ == "__main__":
    main()
