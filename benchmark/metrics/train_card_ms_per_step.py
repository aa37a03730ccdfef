"""The card's milliseconds a training step: the union of the intervals in
which any kernel, copy or set ran on the card, summed over every call of the
window (each traced with the card's activity only), over the window's steps.
It leaves out the host's time between launches, which moves with the
machine's shared cores and not with the program."""


def read(s: dict):
    return s.get("card_ms_per_step")
