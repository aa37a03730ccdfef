"""What both drivers do with the program: its schema and config from the
benchmark's config file, and its model with the benchmark's weights loaded
through its own ``state_dict``; and the set-up clock."""

from __future__ import annotations

import time

import torch

from benchmark import gen
from jodalrob_twotower_torch.config import TrainConfig
from jodalrob_twotower_torch.models import build_model
from jodalrob_twotower_torch.schema import CategoricalSpec, NumericSpec, SideSchema, TextSpec, TwoTowerSchema


def program_schema(schema: dict) -> TwoTowerSchema:
    def side(name: str) -> SideSchema:
        s = schema[name]
        return SideSchema(
            table=name, pk=("id",),
            numeric=tuple(NumericSpec(f"num_{i}") for i in range(s["num_numeric"])),
            categorical=tuple(CategoricalSpec(f"cat_{i}", v) for i, v in enumerate(s["vocab_sizes"])),
            text=tuple(TextSpec(n, d) for n, d in s["text"].items()),
        )

    return TwoTowerSchema(notice=side("notice"), company=side("company"))


def program_config(config_spec: dict) -> TrainConfig:
    return TrainConfig.from_dict(config_spec["train_config"])


def program_model(config_spec: dict, seed: int, device):
    """(model, weights): the program's model, built on ``device`` (its own
    initialisation runs there and is thrown away: on the host it would draw
    every table there, and on the meta device its draws import the
    compiler), with the benchmark's weights for ``seed``
    (``gen.make_weights``) assigned through its ``load_state_dict``
    (strict: every key and shape must match)."""
    with torch.device(device):
        model = build_model(program_schema(config_spec["schema"]), program_config(config_spec))
    w = gen.make_weights({k: tuple(v.shape) for k, v in model.state_dict().items()}, seed, device)
    model.load_state_dict(w, strict=True, assign=True)
    return model, w


def weights(config_spec: dict, seed: int, device) -> dict:
    """The benchmark's weights for the config and ``seed``, keyed as the
    program's ``state_dict`` (the reference reads them by those names)."""
    return program_model(config_spec, seed, device)[1]


class Clock:
    """Seconds of each set-up phase, each read after the card has finished
    it: ``clock(name)`` closes a phase and returns every phase so far."""

    def __init__(self) -> None:
        self.phases: dict[str, float] = {}
        self.t = time.perf_counter()

    def __call__(self, name: str) -> dict:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        now = time.perf_counter()
        self.phases[name] = now - self.t
        self.t = now
        return self.phases
