"""K4, the row gather (``ops/embedding_lookup.embedding_lookup_pallas``,
``csrc/row_gather.cu``): one launch a tower a step on the large-table path."""

KERNELS = r"row_gather_kernel"


def nbytes(ids: int, unique_rows: int, dim: int, elem: int = 4, id_bytes: int = 4) -> int:
    """The ids read, each distinct row read once, the rows written."""
    return ids * id_bytes + (unique_rows + ids) * dim * elem
