"""Kernel K4 (causal prefill attention) at the bursts' prefills: Σ bound time of the window's prefill calls' attention over the time of the K4 kernels those calls launched, %."""

from port_bench import family, flops, readings

# kernel names of the program's hand-written kernel K4
# (fastvlm_tpu_torch/csrc/prefill_attention.cu); a program without it has
# none, and the reading is None
K4 = r"\bprefill_attention_kernel"


def call_bound_s(cfg, info, peak):
    """The least time of one prefill call's attention over all layers:
    causal pairs of its real rows (an image, or more than one token; each
    row's n tokens after the cached offset), clipped to each layer's window
    (the family's ``attention``), at the bf16 peak, or q, the output and
    the keys and values each row attends moved once, the larger."""
    off = info["offset"]
    rows = [n for n, at in zip(info["lens"], info["starts"])
            if at >= 0 or n > 1]
    ops = nbytes = 0
    for hq, hkv, d, window in family.of(cfg).attention(cfg):
        ops += 4 * hq * d * sum(flops.causal_pairs(n, off, window)
                                for n in rows)
        nbytes += flops.BF16 * sum(
            2 * n * hq * d + 2 * flops.keys_read(n, off, window) * hkv * d
            for n in rows)
    return flops.bound_s(ops, nbytes, peak)


def read(ctx):
    prefills = readings._spans(ctx, "prefill")
    if not prefills or ctx.peak is None:
        return None
    kernel = readings._kernel_s(ctx, K4, prefills)
    if kernel <= 0:
        return None
    bound = sum(call_bound_s(ctx.cfg, info, ctx.peak)
                for _, _, _, info in prefills)
    return 100.0 * bound / kernel
