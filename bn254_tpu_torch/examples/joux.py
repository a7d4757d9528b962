"""Joux one-round three-party key agreement via the pairing, on the
port's scalar API — port form of examples/joux.py.

Executable acceptance test of the whole stack (scalar mul in both groups,
pairing, Gt exponentiation); behavioral model: reference examples/
joux.rs:3-22.

    python -m bn254_tpu_torch.examples.joux
"""

import random

from bn254_tpu_torch import Fr, G1, G2, pairing


def main(rng=None):
    """Run the agreement with secret keys drawn from rng (a
    random.Random; the module's generator where None); returns the shared
    secret, a Gt."""
    rng = rng if rng is not None else random.Random()
    alice_sk = Fr.random(rng)
    bob_sk = Fr.random(rng)
    carol_sk = Fr.random(rng)

    alice_pk1, alice_pk2 = G1.one() * alice_sk, G2.one() * alice_sk
    bob_pk1, bob_pk2 = G1.one() * bob_sk, G2.one() * bob_sk
    carol_pk1, carol_pk2 = G1.one() * carol_sk, G2.one() * carol_sk

    alice_ss = pairing(bob_pk1, carol_pk2).pow(alice_sk)
    bob_ss = pairing(carol_pk1, alice_pk2).pow(bob_sk)
    carol_ss = pairing(alice_pk1, bob_pk2).pow(carol_sk)

    assert alice_ss == bob_ss == carol_ss
    print("joux: one-round three-party shared secret agrees")
    return alice_ss


if __name__ == "__main__":
    main()
