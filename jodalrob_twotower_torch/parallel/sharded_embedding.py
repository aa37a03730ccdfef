"""Embedding lookup for replicated tables on a mesh (the reference's
``ShardedDenseGradLookup``, ``jodalrob_twotower_tpu/parallel/sharded_embedding.py:39-220``).

With the mesh's default ``embedding_sharding="auto"`` every unified table
of at most 65,536 rows is replicated (``parallel/mesh.resolve_embedding_sharding``):
cheaper than exchanging rows every step, and it keeps the dense-gradient
kernel. The port needs no lookup of its own for it: each rank runs the
model's unchanged ``models/embedding.EmbeddingCollection`` on its block of
the batch, which on the card takes the one-hot lookup kernel (K1) forward
and the dense table gradient (K2) over the rank's cotangents, exactly the
reference's per-device choice. The [R, D] partials are summed across ranks
by the train step's one all-reduce of every dense gradient
(``parallel/mesh.sync_grads``), where the reference's shard_map ends its
backward with a ``psum`` of them. The reference's explicit row-sharded
exchange (``make_sharded_lookup``) and its GSPMD row-sharded tables wait
for ROADMAP A12b.
"""

from jodalrob_twotower_torch.models.embedding import EmbeddingCollection

# the reference's name for the replicated-table lookup of a mesh rank
ShardedDenseGradLookup = EmbeddingCollection
