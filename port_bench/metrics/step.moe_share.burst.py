"""The routed experts' share of the bursts' prefills on the device: the time of the K5 kernels the window's prefill calls launched over the time of all kernels those calls launched, %."""

from port_bench import readings

# kernel names of the program's hand-written kernel K5
# (fastvlm_tpu_torch/ops/cuda/experts.py); none in a program without it
K5 = r"moe_k5_"


def read(ctx):
    prefills = readings._spans(ctx, "prefill")
    if not prefills:
        return None
    moe = readings._kernel_s(ctx, K5, prefills)
    if moe <= 0:
        return None
    return 100.0 * moe / readings._kernel_s(ctx, r"", prefills)
