"""Launch counts of the kernel wrappers and call counts of their plain
versions.

A wrapper adds one to ``launches[name]`` where it launches its CUDA kernel
and nowhere else; a plain version adds one to ``plain_calls[name]`` each
time it runs.  ``chip_smoke.py`` resets both before it drives a main path
(the pairing, the MSM, the GLV scalar multiplication, the prepared-G2
Miller loop, the throughput probes, the point decompression) and reads them after, to show the path went through every
kernel it uses and through no plain version.
"""

KERNELS = (
    "mont_mul", "mont_sqr", "fq2_mul", "fq2_sqr", "fq_pow",
    "miller_precompute", "g2_add_step", "fq12_fold_line",
    "fq12_mul", "fq12_cyc_sqr", "fq12_cyc_pow",
    "point_add", "point_double", "msm_accumulate",
    "fq12_sqr", "g2_dbl_step", "glv_ladder",
    "fq2_mul_fused", "fq2_sqr_fused", "chain_mont", "chain_tower",
    "msm_bucket_sort", "msm_bucket_reduce",
    "fq12_inv", "fq12_frob",
    "msm_combine", "point_mul",
    "fq2_sqrt",
    "miller_loop",
    "g2_precompute",
    "to_affine",
)

# The kernels each main path launches (chip_smoke.py asserts every one).
PAIRING_PATH = ("to_affine",                                     # G1 and G2, one launch each
                "miller_precompute",                             # the 87 steps, the Frobenius bases
                "fq12_mul", "fq12_cyc_sqr", "fq12_cyc_pow",
                "fq12_inv", "fq12_frob")                          # the final exponentiation
# The one-op kernels that the Miller kernel's Frobenius tail replaced there
FROBENIUS_TAIL_ONE_OPS = ("fq2_mul", "g2_add_step", "fq12_fold_line")
MSM_PATH = ("to_affine",
            "msm_combine",                                        # Horner + lane fold
            "msm_bucket_sort", "msm_accumulate", "msm_bucket_reduce")   # row 19
# The one-op field kernels that to_affine's launch replaced on those two paths
TO_AFFINE_ONE_OPS = ("mont_mul", "mont_sqr", "fq2_sqr", "fq_pow")
GLV_PATH = ("mont_mul",                  # endo: beta x
            "point_add", "glv_ladder")   # p1 + p2, the ladder
PREPARED_MILLER_PATH = ("g2_precompute",   # the 87 lines, the Frobenius bases among them
                        "miller_loop")     # the 87 folds and 64 squares
PROBE_PATH = ("chain_mont",
              "chain_tower",      # one launch an op, each on the engine the main path
                                  # runs it on (fq2: three threads a lane; fq6, fq12: six)
              # each op once as its own kernel, beside its in-chain rate
              # (fq2_mul_fused on the three-thread Fq2 step)
              "mont_mul", "mont_sqr", "fq2_mul_fused", "fq2_sqr_fused",
              "fq12_sqr", "fq12_mul", "fq12_cyc_sqr")
CODEC_PATH = ("mont_mul", "mont_sqr", "fq2_mul", "fq2_sqr",   # curve equation, y choice
              "fq_pow",                                       # the Fq sqrt
              "fq2_sqrt",                                     # the Fq2 sqrt
              "point_mul")                                    # G2 subgroup check

launches = dict.fromkeys(KERNELS, 0)
plain_calls = dict.fromkeys(KERNELS, 0)


def reset():
    for d in (launches, plain_calls):
        for k in d:
            d[k] = 0
