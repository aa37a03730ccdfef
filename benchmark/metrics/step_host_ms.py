"""Host milliseconds of one training step, the program's ``train.step``
span (the batch's draw and gather, forward, backward and the optimizer's
update, all dispatched), the median over the steps run outside any profiler
session. The inside counterpart of ``host_examples_per_s``, which times
whole calls from outside, each ended by fetching its losses."""

from benchmark import spans


def read(s: dict):
    return spans.median_ms(spans.roots(s, "train.step"))
