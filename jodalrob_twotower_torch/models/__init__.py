from jodalrob_twotower_torch.models.embedding import EmbeddingCollection  # noqa: F401
from jodalrob_twotower_torch.models.tower import Tower  # noqa: F401
from jodalrob_twotower_torch.models.two_tower import TwoTowerModel


def build_model(schema, cfg, mesh=None) -> TwoTowerModel:
    """Construct the model the config asks for, on one device, with the
    row-gather kernel where ``MeshConfig.use_pallas_lookup`` asks for the
    reference's Pallas gather. Meshes wait for the parallel slice."""
    if mesh is not None:
        raise NotImplementedError(
            "the port runs on one device; mesh-sharded models arrive with the parallel slice"
        )
    return TwoTowerModel(schema, cfg.model, cfg.mesh.use_pallas_lookup)
