"""Share of its HBM roofline that the fused loss takes in the step
(``csrc/fused_loss.cu``, ``fwd_kernel`` and ``bwd_kernel``): the bytes each
launch must move at the update's shapes (``harness/flops.py``), over the
card's HBM bandwidth, over the kernels' device time, summed over the
traced epoch's launches."""
LAYER, UNIT, SOURCE, MOVES, BETTER = ("kernels", "%", "device_trace", "train_slices_per_s",
                                      "higher")


def read(ctx):
    s = ctx["summary"]
    if s is None:
        return None
    nbytes = ctx["flops"].fused_loss_bytes(ctx["flags"])
    fwd_us, fwd_n = s.kernel_us("::fwd_kernel<")
    bwd_us, bwd_n = s.kernel_us("::bwd_kernel<")
    if not fwd_n or not bwd_n:
        return None
    least_s = (fwd_n * nbytes["fwd_kernel"] + bwd_n * nbytes["bwd_kernel"]) \
        / ctx["peaks"].HBM_BYTES_PER_S
    return 100.0 * least_s / ((fwd_us + bwd_us) / 1e6)
