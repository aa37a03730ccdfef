"""Examples trained over the host-clock seconds of the traced run's untraced
pass (``trace_calls`` whole calls, each ended by fetching its losses): the
rate a user sees where the host paces the step, read beside the card's time
since it moves with the machine as much as with the program."""


def read(s: dict):
    return s.get("host_examples_per_s")
