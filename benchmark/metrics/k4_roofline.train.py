"""Kernel 4 (the touched-row apply, csrc/streamed_update.cu) against its
roofline in the traced training steps, the distinct rows counted from
the batch."""
from benchmark import readers, work

KERNELS = (r"anonymous namespace\)::apply_kernel", r"anonymous namespace\)::apply_chunked_kernel")


def read(run):
    return readers.roofline(
        run, KERNELS,
        lambda item: work.k4(run.model, item["distinct"], run.table_bytes, run.optimizer),
        "streamed_rowwise_apply")
