"""K1 and K2, the one-hot lookup and the table gradient (one launch of each
a tower a step): the least time their launches need, from the distinct
table rows each step's ids touched, over their card time, in %."""

from benchmark import peaks
from benchmark.rooflines import device_us, k1_onehot_lookup, k2_table_grad


def read(s: dict):
    if "lookups" not in s:
        return None
    us = device_us(s, k1_onehot_lookup.KERNELS) + device_us(s, k2_table_grad.KERNELS)
    if not us:
        return None
    nbytes = 0
    for side in s["lookups"].values():
        shape = (s["batch"], side["features"], side["dim"], side["table_rows"])
        nbytes += sum(k1_onehot_lookup.nbytes(*shape, u) for u in side["unique_rows"])
        nbytes += k2_table_grad.nbytes(*shape) * len(side["unique_rows"])
    return 100.0 * peaks.bound_s(nbytes=nbytes) / (us / 1e6)
