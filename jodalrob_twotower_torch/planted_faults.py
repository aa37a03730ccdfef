"""Shows that ``chip_smoke.py``'s step check (one B=1024 step's loss and
gradients on the card against the same step on the CPU) fails on a wrong
kernel: plants a fault in the output of a CUDA wrapper - the table gradient
(K2) losing whole 128-row tiles, or the CE backward (K11) losing rows of dc -
runs the check once sound and once per fault, and reports each fault as
caught or not. The CPU side of the check takes the plain versions, so only
the card's side carries the fault.

Run from the repository root on a machine with a CUDA card:
``python3 -m jodalrob_twotower_torch.planted_faults``. Exits nonzero if the
sound check fails or a fault goes uncaught.
"""

from __future__ import annotations

import sys

from jodalrob_twotower_torch.ops import embedding_grad, fused_logits


def _tile_loss(every: int):
    """K2 whose every ``every``-th tile of the table gradient comes out 0."""
    real = embedding_grad.dense_table_grad

    def fault(rows, g, tile_feature):
        out = real(rows, g, tile_feature)
        if out.is_cuda:
            out.view(-1, embedding_grad.TILE_ROWS, out.shape[1])[::every] = 0
        return out

    fault.launches = 0  # the wrapper counts its launches on the module's name
    return embedding_grad, "dense_table_grad", fault


def _dc_loss(rows_lost: int):
    """K11 whose first ``rows_lost`` rows of dc come out 0."""
    real = fused_logits.fused_ce_bwd

    def fault(*args):
        dn, dc = real(*args)
        if dc.is_cuda:
            dc[:rows_lost] = 0
        return dn, dc

    fault.launches = 0
    return fused_logits, "fused_ce_bwd", fault


FAULTS = {
    "K2 loses every 16th tile": lambda: _tile_loss(16),
    "K2 loses every 64th tile": lambda: _tile_loss(64),
    "K11 loses dc rows 0..63": lambda: _dc_loss(64),
    "K11 loses dc rows 0..7": lambda: _dc_loss(8),
}


def main() -> int:
    import chip_smoke  # the repository root's smoke script: run from the root

    print(chip_smoke.bench.card_line(), flush=True)
    chip_smoke._build.build(chip_smoke.KERNEL_SOURCES)
    chip_smoke.step_grad_check()
    print("sound step check passed", flush=True)
    missed = []
    for name, make in FAULTS.items():
        module, attr, fault = make()
        real = getattr(module, attr)
        setattr(module, attr, fault)
        try:
            chip_smoke.step_grad_check()
            missed.append(name)
            print(f"planted fault NOT caught: {name}", flush=True)
        except RuntimeError as e:
            print(f"planted fault caught: {name}: {e}", flush=True)
        finally:
            setattr(module, attr, real)
    return 1 if missed else 0


if __name__ == "__main__":
    sys.exit(main())
