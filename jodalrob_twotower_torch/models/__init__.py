from jodalrob_twotower_torch.models.embedding import EmbeddingCollection  # noqa: F401
from jodalrob_twotower_torch.models.tower import Tower  # noqa: F401
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel


def build_model(schema, cfg, mesh=None) -> TwoTowerModel:
    """Construct the model the config asks for, on one device. Meshes and the
    reference's Pallas gather (``MeshConfig.use_pallas_lookup``) wait for the
    parallel slice and the port of that kernel."""
    if mesh is not None:
        raise NotImplementedError(
            "the port runs on one device; mesh-sharded models arrive with the parallel slice"
        )
    if cfg.mesh.use_pallas_lookup:
        raise NotImplementedError(
            "MeshConfig.use_pallas_lookup selects the reference's Pallas gather "
            "kernel, which is not ported yet (ROADMAP.md)"
        )
    return TwoTowerModel(schema, cfg.model)
