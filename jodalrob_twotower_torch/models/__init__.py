from jodalrob_twotower_torch.models.embedding import EmbeddingCollection  # noqa: F401
from jodalrob_twotower_torch.models.tower import Tower  # noqa: F401
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel


def build_model(schema, cfg, mesh=None) -> TwoTowerModel:
    """Construct the model the config asks for (reference
    ``models.build_model``): the row-gather kernel where
    ``MeshConfig.use_pallas_lookup`` asks for the reference's Pallas gather,
    and on a mesh of more than one rank (``parallel/mesh.py``) the towers of
    the rank's batch block, with global BatchNorm statistics.

    The tables follow ``embedding_sharding`` ("auto" resolves to
    "replicated" up to 65,536 rows, else "gspmd_rows"): replicated tables
    keep each rank's unchanged lookup, which chooses its kernels as one
    device does; "gspmd_rows" and "shard_map" row-shard every table over
    the ranks and look up through the row exchange
    (``parallel/sharded_embedding.make_sharded_lookup``). The reference's
    two modes differ only in who writes the exchange (XLA's GSPMD or the
    code); the port has one exchange for both. Sparse tables on a mesh are
    row-sharded too.

    Under the compressed gradient sync (``grad_compression`` other than
    "none", ``parallel/compressed_grads.py``) every rank trains its block as
    a batch of its own, as the reference's explicit ``shard_map`` step does
    with the plain lookup (its :15-21): BatchNorm takes the rank's
    statistics, dropout the rank's masks, and the tables are replicated
    (each rank's lookup as one device's), or row-sharded for sparse
    tables, whose exchange stays exact."""
    if mesh is not None and mesh.size > 1 and cfg.mesh.grad_compression != "none":
        return TwoTowerModel(schema, cfg.model, cfg.mesh.use_pallas_lookup, mesh=mesh,
                             row_sharded=bool(cfg.sparse_tables), per_rank=True)
    row_sharded = False
    if mesh is not None and mesh.size > 1:
        from jodalrob_twotower_torch.parallel.mesh import resolve_embedding_sharding

        mode = resolve_embedding_sharding(cfg.mesh, schema)
        if cfg.model.embedding_lookup == "onehot" and mode == "shard_map":
            raise ValueError(
                "embedding_lookup='onehot' forced, but the configured embedding sharding ('shard_map') "
                "installs a lookup that does not carry the one-hot kernel - use "
                "embedding_sharding='replicated' (the kernel runs per rank) or embedding_lookup='auto'"
            )
        if cfg.model.embedding_lookup == "onehot" and mode == "gspmd_rows":
            raise ValueError(
                "embedding_lookup='onehot' cannot run under embedding_sharding='gspmd_rows' on a "
                "multi-device mesh - use 'replicated' (the kernel runs per rank) or embedding_lookup='auto'"
            )
        row_sharded = mode in ("gspmd_rows", "shard_map") or bool(cfg.sparse_tables)
    return TwoTowerModel(schema, cfg.model, cfg.mesh.use_pallas_lookup, mesh=mesh, row_sharded=row_sharded)
