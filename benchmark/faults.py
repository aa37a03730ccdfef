"""Faults planted in the program, for the tests and the calibration that
show the comparison catches them. Each is a context manager that patches the
program's module for the length of the block.

- ``unchanged``: a step that returns its state unchanged (the optimizer's
  update does nothing);
- ``half_batch``: half of the batch left out, the loss the mean over the rest;
- ``altered_answer``: one served company replaced where the index produces it.
"""

from __future__ import annotations

import contextlib

from jodalrob_twotower_torch.serving import index as index_mod
from jodalrob_twotower_torch.train import optimizer as optimizer_mod
from jodalrob_twotower_torch.train import train_step as train_step_mod


@contextlib.contextmanager
def _patched(obj, name: str, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _no_update(self, params, grads, state, **kw) -> None:
    return None


def _half_batch_loss(inner):
    def compute_loss(loss_type, notice_emb, company_emb, **kw):
        half = notice_emb.shape[0] // 2
        return inner(loss_type, notice_emb[:half], company_emb[:half], **kw)

    return compute_loss


def _altered(inner):
    def topk_body(self, queries, k):
        s, i = inner(self, queries, k)
        i = i.clone()
        i[0, 0] = (i[0, 0] + 1) % len(self)
        return s, i

    return topk_body


@contextlib.contextmanager
def plant(name: str | None):
    if name is None:
        yield
    elif name == "unchanged":
        with _patched(optimizer_mod.Optimizer, "update", _no_update):
            yield
    elif name == "half_batch":
        with _patched(train_step_mod, "compute_loss", _half_batch_loss(train_step_mod.compute_loss)):
            yield
    elif name == "altered_answer":
        with contextlib.ExitStack() as stack:
            for cls in (index_mod.BruteForceIndex, index_mod.Int8Index):
                stack.enter_context(_patched(cls, "topk_body", _altered(cls.topk_body)))
            yield
    else:
        raise ValueError(f"unknown fault {name!r}")


# the faults each driver's cells can have
FAULTS = {"train": ("unchanged", "half_batch"), "serve": ("altered_answer",)}
