"""Device milliseconds a traced training step keeps the card busy with
what the port's spans cffm.table_round launched: the rounded writes into
a bf16 table of the touched rows and of the small-field prefix (the
update's rounding, its dither and the write back), summed over the spans
of a cffm.step and averaged over the steps (`benchmark/spans.py`). None
from a port without the span, or unless every step holds one."""
from benchmark import spans


def read(run):
    tops = spans._tops(run, "cffm.step")
    pairs = None if tops is None else spans.launched(run)
    if pairs is None:
        return None
    marks = spans._marks(run, "cffm.table_round")
    kids = [[k for k in marks if a <= k[0] and k[1] <= b] for a, b in tops]
    if not all(kids):
        return None
    ns = 0
    for a, b in (k for step in kids for k in step):
        end = 0
        for s, e in sorted((s, e) for c, s, e in pairs if a <= c <= b):
            ns += max(0, e - max(s, end))
            end = max(end, e)
    return ns / 1e6 / len(tops)
