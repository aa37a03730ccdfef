"""Host milliseconds of one search, the program's ``serve.search`` span:
the notice encoding, the index's scan and its rescore enqueued on the card
(and any wait for room there), the median over the requests served outside
any profiler session."""

from benchmark import spans


def read(s: dict):
    return spans.median_ms(spans.roots(s, "serve.search"))
