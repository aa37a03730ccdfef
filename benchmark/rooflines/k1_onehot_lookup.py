"""K1, the one-hot lookup (``ops/embedding_grad.dense_table_lookup``,
``csrc/onehot_lookup.cu``): one launch a tower a step."""

KERNELS = r"onehot_lookup_kernel"


def nbytes(batch: int, features: int, dim: int, table_rows: int, unique_rows: int, table_elem: int = 4) -> int:
    """The int32 ids and the tile map read, each distinct row read once, the
    bf16 activations written."""
    return batch * features * 4 + (table_rows // 128) * 4 + unique_rows * dim * table_elem + batch * features * dim * 2
