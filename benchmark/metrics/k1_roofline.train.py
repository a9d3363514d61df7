"""Kernel 1 (the fused cross + conv1 forward, csrc/cross_conv1_fwd.cu)
against its roofline in the traced training steps."""
from benchmark import readers, work

KERNELS = (r"cross_conv1_fwd",)


def read(run):
    return readers.roofline(run, KERNELS, lambda item: work.k1(run.model, item["batch"]),
                            "cross_conv1_lin_fm2")
