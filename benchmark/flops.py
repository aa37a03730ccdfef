"""Model FLOPs of a training step and of a served batch, frozen from the
program's ``utils/flops.py`` so that a later change to the program cannot
move the ``mfu`` base.

Model FLOPs are the operations the algorithm needs: 2 m n per [m] -> [n]
dense layer a row; a training step's towers cost three forwards (forward
and backward); the [B, B] logits 2 B^2 D forward and 2 B^2 D for each of
dN = A C and dC = A^T N. The table lookups and updates count no FLOPs.
"""

from __future__ import annotations


def tower_forward_flops(side: dict, model: dict) -> int:
    """One tower's forward FLOPs a row; ``side`` and ``model`` from a config file."""
    proj = model["dense_projection_dim"]
    hidden = model["tower_hidden_dims"]
    f, blocks = 0, 0
    if side["num_numeric"]:
        f += 2 * side["num_numeric"] * proj
        blocks += 1
    for width in side["text"].values():
        f += 2 * width * proj
        blocks += 1
    width = 0
    if blocks:
        f += 2 * blocks * proj * hidden[0]
        width += hidden[0]
    width += len(side["vocab_sizes"]) * model["categorical_embedding_dim"]
    for w in hidden[1:]:
        f += 2 * width * w
        width = w
    return f + 2 * width * model["final_embedding_dim"]


def train_step_flops(config_spec: dict, batch: int) -> int:
    schema, model = config_spec["schema"], config_spec["train_config"]["model"]
    towers = sum(tower_forward_flops(schema[s], model) for s in ("notice", "company"))
    return (3 * towers + 6 * batch * model["final_embedding_dim"]) * batch


def serve_batch_flops(config_spec: dict, queries: int, corpus: int) -> int:
    """The notice tower on the queries and the exact product against every
    corpus row."""
    schema, model = config_spec["schema"], config_spec["train_config"]["model"]
    return queries * tower_forward_flops(schema["notice"], model) + 2 * queries * corpus * model["final_embedding_dim"]
