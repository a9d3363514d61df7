"""Kernel 3 (the sorted-segment sum of the big fields' row gradients,
csrc/sorted_segment.cu: its reduce passes and fill) against its roofline
in the traced training steps, the distinct rows counted from the batch."""
from benchmark import readers, work

KERNELS = (r"anonymous namespace\)::reduce_kernel", r"anonymous namespace\)::fill_kernel")


def read(run):
    return readers.roofline(run, KERNELS,
                            lambda item: work.k3(run.model, item["ids"], item["distinct"]),
                            "sorted_segment_sum_compact")
