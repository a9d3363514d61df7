"""Kernel 2 (the fused backward, csrc/cross_conv1_bwd.cu, with its
partial-sum kernel) against its roofline in the traced training steps."""
from benchmark import readers, work

KERNELS = (r"cross_conv1_bwd", r"sum_partials_kernel")


def read(run):
    return readers.roofline(run, KERNELS, lambda item: work.k2(run.model, item["batch"]),
                            "cross_conv1_bwd")
