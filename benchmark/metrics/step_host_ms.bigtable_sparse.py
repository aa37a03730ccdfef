"""Host milliseconds of one sparse training step, the program's
``train.sparse_step`` span (the batch's draw and gather, forward, backward,
AdamW on the dense leaves and rowwise Adagrad on the touched rows, all
dispatched), the median over the steps run outside any profiler session."""

from benchmark import spans


def read(s: dict):
    return spans.median_ms(spans.roots(s, "train.sparse_step"))
