"""Launch counts of the kernel wrappers and call counts of their plain
versions.

A wrapper adds one to ``launches[name]`` where it launches its CUDA kernel
and nowhere else; a plain version adds one to ``plain_calls[name]`` each
time it runs.  ``chip_smoke.py`` resets both before it drives a main path
(the pairing, the MSM) and reads them after, to show the path went
through every kernel it uses and through no plain version.
"""

KERNELS = (
    "mont_mul", "mont_sqr", "fq2_mul", "fq2_sqr", "fq_pow",
    "miller_precompute", "g2_add_step", "fq12_fold_line",
    "fq12_mul", "fq12_cyc_sqr", "fq12_cyc_pow",
    "point_add", "point_double", "msm_accumulate",
)

# The kernels each main path launches (chip_smoke.py asserts every one).
PAIRING_PATH = KERNELS[:11]
MSM_PATH = ("mont_mul", "mont_sqr", "fq2_mul", "fq2_sqr", "fq_pow",   # to_affine
            "point_add", "point_double", "msm_accumulate")

launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)


def reset():
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0
