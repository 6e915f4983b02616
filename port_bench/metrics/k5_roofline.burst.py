"""Kernel K5 (routed experts) at the bursts' prefills: Σ bound time of the window's prefill calls' expert layers over the time of the K5 kernels those calls launched, %."""

from port_bench import family, readings

# kernel names of the program's hand-written kernel K5
# (fastvlm_tpu_torch/ops/cuda/experts.py, Triton); a program without it
# has none, and the reading is None
K5 = r"moe_k5_"


def read(ctx):
    prefills = readings._spans(ctx, "prefill")
    fam = family.of(ctx.cfg)
    if not prefills or ctx.peak is None or not hasattr(fam, "k5_call_bound_s"):
        return None
    kernel = readings._kernel_s(ctx, K5, prefills)
    if kernel <= 0:
        return None
    bound = sum(fam.k5_call_bound_s(ctx.cfg, info, ctx.peak)
                for _, _, _, info in prefills)
    return 100.0 * bound / kernel
