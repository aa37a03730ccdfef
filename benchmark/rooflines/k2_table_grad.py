"""K2, the table gradient (``ops/embedding_grad.dense_table_grad``,
``csrc/table_grad.cu``): one launch a tower a step, in the backward."""

KERNELS = r"table_grad_kernel"


def nbytes(batch: int, features: int, dim: int, table_rows: int) -> int:
    """The int32 rows and the bf16 cotangent read, the tile map read, the
    whole f32 table gradient written."""
    return batch * features * 4 + batch * features * dim * 2 + table_rows * dim * 4 + (table_rows // 128) * 4
